"""Drive the PyTorch port on one NVIDIA GPU: build its kernels, check each
against its plain PyTorch version, serve a few requests of the flagship
encoder forward, train the same encoder for a few steps, then train and
serve the sparse-input models, all through ``aesara_tpu_torch.function``.

    python3 chip_smoke.py
    python3 chip_smoke.py --k6-sweep    # only K6's tuning table (see k6_sweep)
    python3 chip_smoke.py --k2-walk-sweep    # only K2's walked-tile table (see k2_walk_sweep)
    python3 chip_smoke.py --attention-times    # only K2's and K3's times (see attention_times)
    python3 chip_smoke.py --profile-check    # only how often a profiled window of predict loses launches
    python3 chip_smoke.py --k7-sweep    # only K7's tuning table (see k7_sweep)
    python3 chip_smoke.py --k4-times    # only K4 against torch.log_softmax, and its sweeps (see k4_times)
    python3 chip_smoke.py --k4-k7-times    # only K7's and K4's times, for two checkouts (see k4_k7_times)
    python3 chip_smoke.py --loop-times    # only TP's and TB's checks and times, for two checkouts (see loop_times)
    python3 chip_smoke.py --mrg-times    # only TM's checks and times, for two checkouts (see mrg_times)
    python3 chip_smoke.py --reference    # only the setup and path (e), the reference configurations
    python3 chip_smoke.py --scan    # only the setup and path (f), Scan: config 4 and the LSTM
    python3 chip_smoke.py --decoder    # only the setup and path (g), the decoder LM served
    python3 chip_smoke.py --decoder-sampling    # only the setup and path (h): sampling, speculative, beam
    python3 chip_smoke.py --bf16    # only the setup and path (i): bfloat16, remat, the decoder trained
    python3 chip_smoke.py --convnet    # only the setup and path (j): the conv net and control flow
    python3 chip_smoke.py --ctc-random    # only the setup and path (k): CTC, the distributions, MRG31k3p
    python3 chip_smoke.py --fp16    # only the setup and path (l): bf16 and fp16 beyond PR 16
    python3 chip_smoke.py --seed 3    # path (j)'s synthetic images from another seed (default 0)

Every compiled function runs captured (``TorchLinker``'s default on the
card): its first call with a key runs eagerly, the second captures the
step into a CUDA graph, later ones replay it.  A kernel's wrapper counts
its launches where it launches, the eager ones and those recorded into a
graph while it is captured; a replay calls no wrapper, and the linker
tallies the launches it replays apart (``.replayed``).  Every profiled
run holds the trace's launches of K1-K7 and of the threefry kernel (TF) to
the launches plus the replay tally over the same calls, and fails if they
differ.  Each path checks
that its last call replayed a graph (a ``predict`` request that brings a
new CSR matrix is a new key and runs eagerly, as it should).

Phases (any failure raises and the exit code is non-zero):

0. setup: a CUDA device is required; prints the card's name and power
   limit; builds the flash-attention forward (K2) and backward (K3), the
   row softmax (K4) and the CSR (K5-K7) kernels with nvcc for sm_90a, one
   nvcc per source, all at once, and compiles one fused-elemwise kernel
   (K1) and the threefry kernel (TF) with Triton.
1. kernels: K1 and K2 against their plain versions on the card, at the
   shapes the forward gives them (K2 also at ragged, padded and D = 128
   panels), with the times of both; K2's resources (registers, shared
   memory, resident blocks) and, at the flagship panels, two calls with
   the same bits and scaled_dot_product_attention's time and backend
   beside the 3xTF32 bound.
2. forward: the 4-layer encoder (d_model 1024, 16 heads, d_ff 4096,
   float32, random weights from seeds) compiled with the TORCH mode on
   the card answers 3 requests of (8, 1024, 1024); the kernels' launch
   counts show the forward went through them, and one sequence is held
   against the same graph compiled for the CPU.
3. train kernels: K1 on the train step's Composites and K3 against their
   plain versions on the card, with the times of both and of PyTorch's
   memory-efficient attention backward (K3's backward kernels alone against
   it, beside the 3xTF32 bound); K3's resources (registers, shared memory,
   resident blocks) and, at the flagship shape, two calls with the same bits.
4. train: the train step of the same encoder (symbolic ``grad``, ``sgd``
   updates of the shared parameters, ``x`` a shared (8, 1024, 1024)
   tensor on the card, as ``benchmarks/bench_transformer.py:26-67``
   builds it) takes 3 steps; the launch counts show every step went
   through K1, K2 (forward and K3's recompute) and K3, and the loss falls
   below the first step's.
   Then 10 steps are timed back to back and 3 are profiled (after one
   that the profiler traces and drops and one lead-in that a marker
   kernel sets apart in the trace), the trace's launches of K1-K7
   held against the counters and the replay tally.  The same step at batch 1 on the card
   and on the CPU agrees after one step.
4d. AdamW train: the same encoder trained the way its users train it,
   ``adamw(loss, params, lr=warmup_cosine(s, 1e-3, 2, 13),
   weight_decay=0.01, grad_clip=1.0)`` with ``s`` a shared step counter
   updated in the same function: K1 on each of its Composites that the
   sgd step lacks against the plain version (time and bound at a (1024,
   4096) weight); 3 steps with launch counts (K1, K2 and K3 every step);
   10 timed back to back and 3 profiled, after which the schedule has
   ended and the loss must lie below the first step's (the first update
   runs at lr 0, the next ones overshoot before it falls); then 2 steps
   at batch 1 on the card and on the CPU, every parameter, moment and
   counter held.
5. (a) bag-of-words classifier: ``LogisticRegression(130107, 20)`` on a
   shared CSR x of the 20 Newsgroups training split's size (11,314
   documents, synthetic, from a seed): K6 (forward, the weights'
   gradient on the transposed twin, where two calls must give the same
   bits, and one ``predict`` request whose plan is made in the call) and
   K4 against their plain versions at the step's shapes; 3 sgd steps with
   launch counts, 10 timed, 3 profiled; ``predict`` answers 3 requests
   and, captured, the last of them 3 times more under the profiler; one
   step at 512 documents on the card against the CPU.
6. (b) sparse GLM: the repo's config 5 at ``REFRATIO_SCALE=4``
   (``benchmarks/bench_reference_ratio.py:276-321``, 16384 x 8192 at
   density 0.01, with its Monte-Carlo noise ``eps =
   RandomStream(42).normal(size=(d,)) * 0.01`` drawn each step): K5
   against its plain version, K5 and K6 timed at rhs widths 1-32 (the
   split between them), 3 + 10 steps with launch counts (one threefry
   launch a step), w after the 3 steps against the CPU's, and the noise's
   key after every call the host's key after as many draws, bit for bit
   (replays draw fresh noise).  Then the optimizers on the GLM's w,
   each on the card and on the CPU from the same values, with launch
   counts: one step each of ``momentum``, ``rmsprop`` and ``adam``, two of
   ``accumulate_gradients(every=2)`` driving ``adamw_from_grads``, two of
   ``scaled_loss_updates`` driving ``adamw_from_grads`` with
   ``ema_updates`` (``switch``, ``isnan``/``isinf`` and ``any`` on the
   card); every parameter and piece of state held against the CPU.
7. (c) the gradient with respect to x's stored values at the GLM's size,
   for a rhs of width 1 and of width 20: K7 (two calls with the same
   bits), and K6 at width 20, against their plain versions, the
   function's launches, 3 captured calls at width 20 profiled, its output
   against the same function on the CPU.
e. the repo's reference configurations (``benchmarks/
   bench_reference_ratio.py:146-250`` at REFRATIO_SCALE=4, built as it
   builds them, float32, data from its seeds in shared variables on the
   card): config 1, sigmoid logistic regression on 16,384 x 784 (sgd
   0.1); config 2, the softmax chain on 8,192 x 1,024 (4 Softmax, K4 at
   width 1,024); config 3, the MNIST MLP 784-512-512-10 with tanh, sgd
   0.01, its minibatch of 512 chosen by ``givens={x: Xd[idx*B:(idx+1)*B],
   ...}`` over 10 minibatches (2 DynamicSlice, the start computed on the
   card); and the ``MLP`` model with sigmoid at the same widths on the
   same givens (K4's log-softmax at (512, 10)) with ``predict``.  For
   each: K1 on every Composite it runs against the plain version (values
   in (0.05, 0.95), with times and bounds), 3 counted steps, 10 timed and
   3 profiled, the loss falls (config 2: the same output every call),
   every call replays one captured graph, each of the 10 minibatches
   replayed equals its eager step, one step at full width on the card
   against the CPU (loss and every parameter, TRAIN_TOL), and K4 at
   config 2's softmax and the MLP's log-softmax against the plain version
   and ``torch.softmax``/``torch.log_softmax``.
7f. (f) Scan: config 4 of ``benchmarks/bench_reference_ratio.py:247-276``
   at REFRATIO_SCALE=4 (an Elman RNN over a shared (128, 128, 64) x, hidden
   128, float32, sgd 0.01, trained by BPTT through the reverse Scan) and
   ``LSTM(64, 128, 10)`` with adam on an input X of the same T and batch
   (its slices of X have bounds computed from X's shape, folded on the
   host).  For each: the ``FAST_RUN`` op counts, outer and of each Scan's
   inner graph, equal the JAX package's (``SCAN_JAX_COUNTS``); K1 on every
   Composite, the inner programs' too, against the plain version; 3
   counted steps (each Scan's inner launches counted a step: 128 steps a
   call), 10 timed and 3 profiled, every loop captured unrolled into the
   step's CUDA graph; the loss falls; one step at full width on the card
   against the CPU; the LSTM's 3 ``predict`` requests of new sequences
   against the host's logits, and K4 at its (128, 10) log-softmax against
   the plain version and ``torch.log_softmax``.
g. (g) the decoder LM served (``aesara_tpu_torch/models/decoder.py``,
   ``quant.py``, ``serve.py``) at ``benchmarks/bench_decode.py``'s width:
   ``DecoderLM(32000, 4, 512, 8, 2048, seed=0)`` in float32 (its graph
   turns float64 at the scores' ``/ np.sqrt(dh)``, as the JAX package's
   does).  (g1) ``generate_fn(256, t_max=512)`` from token 17; (g2)
   ``generate_from_prompt_fn(256, 8, 512)`` on ``(arange(256) * 7) %
   32000``; (g3) ``generate_batched_fn(32, 256, 512)`` on ``arange(32)``;
   (g4) ``quantize_decoder_int8`` of the same model, greedy 256; each 3
   counted calls (eager, capture, replay), 10 timed and ((g2)) 3
   profiled, with tokens/s, host time of one call, busy share, a replay's
   device events (its graph's kernels, copies and sets), the capture's
   seconds and peak and reserved memory.  (g1) and (g2) against the same graph on the CPU,
   two of (g3)'s streams against single-stream decode, each under the tie
   rule (a first difference only where the CPU's top-2 logit gap there is
   under TIE_REL of the logits' scale, and the comparison stops there);
   (g4)'s first 32 tokens against (g1)'s, printed.  An eager twin of (g1)
   at 16 tokens copies a cache's shape no more than 9 times a call (the
   Alloc of the zeros, and the loop's own copy of each of its 8 caches: it
   writes each K/V row in place), counted from the op trace.  (g5)
   ``ContinuousBatcher(DecoderLM(2048, ...), n_slots=32, t_max=256,
   t_pad=32)`` at ``bench_serving.py``'s settings (32 prompts of 16 tokens
   from ``default_rng(0)``, 64 new each) for chunk 1 and 16: a first drain,
   then a second one timed with every call a replay, each request against
   its own ``generate_from_prompt_fn`` under the tie rule, and ``_decode``
   timed and profiled.  K1 on every Composite of (g) and K4 (fp64, as the
   graph computes it) at the decode, batched and prefill softmaxes against
   their plain versions and ``torch.softmax``.
h. (h) the decoder's cut features on (g)'s model (its set-up and kernel
   checks run before path (g), its runs after): the threefry kernel
   bitwise against its plain version at 1, 31, 32,000 and 2**20 + 3
   values in 32- and 64-bit bits and float32/float64 uniforms, from keys
   of seeds 0 and 42 and an all-ones key, with its time at the decoder's
   draw against the plain version's and its bound; K1 on every Composite
   of (h) and K4 at the beam's and the verify block's softmax rows.
   (h1) ``generate_fn(256, t_max=512, temperature=0.8)`` from token 17,
   and the same with ``top_k=40``: 3 counted calls, 10 timed, 3
   profiled, captured; 257 threefry launches a call (one a step, and the
   stream's key advanced once outside the loop, as the JAX package's
   default update does: each call draws other noise, and the key after
   every call is the host's after as many draws); call 3, a replay,
   against the same graph on the CPU from its key under the sampling tie
   rule (a first difference only where the CPU's scores of the two
   tokens, logits / T plus the host's Gumbel noise, differ by under
   TIE_REL of the largest finite score, a token below the top-k never);
   not the greedy tokens.  (h2) ``speculative_generate_fn`` with
   ``DecoderLM(32000, 1, 512, 8, 2048, seed=1)`` as draft, 64 tokens after
   (g2)'s prompt with 4 proposals a round, and the target as its own draft
   at 33: eager (a while-Scan), 3 calls each, tokens/s, against the
   target's own ``generate_from_prompt_fn`` under the tie rule.  (h3)
   ``beam_search_fn(256, 32, 512, beam=4)`` captured (3 + 10 + 3 calls),
   its tokens and score against the CPU's (score within BEAM_SCORE_REL) at
   BEAM_PROMPT_STRIDES' three prompts, the same tokens' score recomputed
   on the host from the CPU's logits by an fp64 path (within it) and by an
   fp32 path (which must fail it),
   and beam 1 at 8 tokens against (g2)'s greedy tokens.
i. (i) bfloat16 graphs, ``remat`` and the decoder LM trained, with
   PyTorch's reduced-precision reductions off (a bfloat16 Dot sums in
   fp32).  (i1) ``benchmarks/bench_transformer.py``'s bfloat16 row: the
   4-layer encoder above in bfloat16 (x ``normal * 0.1`` of
   ``default_rng(0)``, sgd 0.01): K1 on its bfloat16 Composites against
   the plain versions (within BF16_REL of the scale), 3 counted steps (the
   loss below the first step's), 10 timed and 3 profiled; at batch 1
   against the CPU, the loss and every gradient within BF16_REL of its
   scale plus the CPU's own distance from the float64 gradient of the same
   bfloat16 start, and the loss and every parameter after one step within
   BF16_REL of its scale.  K2 and K3 in bfloat16 at (i1)'s and (i2)'s
   panels, (128, 1024, 64) and (128, 2048, 128): against the plain
   versions, two calls with the same bits, times beside
   ``scaled_dot_product_attention``'s (backend named) and the fastest
   backward it offers, bounds at the dense bf16 rate (made with phase 3's
   checks, early in the run).  (i2) ``run_model_scale_remat``, cut from 12
   to 8 layers of (2048, 16, 8192) at 8 x 2048 tokens in bfloat16 (403 M
   parameters; since PR 21, for the run's time),
   remat off then on in one process, each with its gradients at the start,
   3 counted steps (every launch of the inner programs of the Remat nodes
   counted), N_SCALE_TIMED timed and 3 profiled; the two arms' gradients,
   and their losses and parameters after the 3 steps, bitwise equal (else
   each within BF16_REL and the differing ones logged), and the remat
   arm's peak memory below the other's.  (i3)
   ``examples/production_training.py`` at (g)'s width: ``DecoderLM(32000,
   4, 512, 8, 2048)`` trained by ``scaled_loss_updates`` around
   ``adamw_from_grads(weight_decay=0.01)`` under ``warmup_cosine(3e-3, 20,
   200)`` on a shared counter, 16 rows of 257 tokens x 2 epochs with a
   checkpoint after each: K1 on each distinct Composite at the shapes a
   call gives it, every state variable after the first step against the
   CPU (TRAIN_TOL) and the first TRAIN_CPU_STEPS losses against the CPU's
   (TRAIN_LOSS_REL; the schedule overshoots at this width, in the JAX
   package too), the launches of all 32 steps; then the checkpoint loaded
   into a freshly built graph (every state variable bitwise the saved
   one), 8 greedy tokens of the resumed model equal to the CPU's from the
   same checkpoint, and one more step from each graph bitwise equal; K4 at
   its causal softmax, (8 x 256, 256) float64.
j. (j) the conv net, with cuDNN in full fp32, deterministic and not
   autotuning (set and logged first; the linker refuses a convolution
   otherwise).  (j1) ``ConvNet(1, (28, 28), [20, 50], 10, seed=0)`` in
   float32, LeNet's widths (the Aesara tutorial's ``evaluate_lenet5``) on
   the model's 3 x 3 "half" convolutions, on 500 synthetic images and
   labels from SEED: its graph's convolutions, pools, their gradients
   and Composites; K1 on each Composite at the shapes a step gives it and
   K4 at (500, 10) against their plain versions; sgd at 0.1, 3 counted
   steps, 10 timed and 3 profiled (images/s, host time of a call, peak
   memory), the loss after them below the first; each convolution and
   pool node's device time alone; one step at batch 8 against the CPU
   (the loss and every gradient, TRAIN_TOL); 3 ``predict`` requests of
   500 new images and one of 1 against the CPU's labels under the tie
   rule; its "capture table" line, captured bitwise equal to eager.  (j2)
   on (j1)'s model and batch: the step guarded by ``ifelse(isfinite(loss),
   p - 0.1 g, p)``, 3 calls bitwise equal to (j1)'s step from the same
   weights, then a batch with one NaN pixel (loss NaN, every parameter
   unchanged, replayed); an ``Assert`` on the labels' count (from shapes)
   passing on 500, captured, and raising its message on 499; a function
   holding a ``Print`` that runs eagerly, names it as its blocker and
   prints once a call.
k. (k) the CTC loss at Deep Speech 2's output width and the rest of the
   random module.  (k1) Amodei et al. 2016 (arXiv:1512.02595), English: C =
   29 (28 characters and the blank), T = 750 frames (15 s at a 10 ms hop
   after a stride of 2), B = 32 utterances of 600-750 frames, labels of
   150-200 characters with repeats, padded with -1 to 200, from SEED; a
   linear CTC head (W (1024, 29), b) on fp32 features (750, 32, 1024)
   trained by sgd through ``function()`` with updates: K4 at its (24000,
   29) log-softmax against the plain version and ``torch.log_softmax``;
   the loss and both gradients against the CPU at full size (CTC_TOL); a
   batch with an impossible alignment, whose loss is finite (the DP's
   floor) and the CPU's; 3 captured steps (eager, capture, replay) bitwise
   equal to 3 eager ones, with their launches; the step time of 10 steps
   back to back, the device kernels of a replay and its device time by
   group (K4, K1, GEMM, the DP's torch ops).  Then TG (fp64 and log
   space, fp32), TP and TB (fp64, fp32) and TM (fp32, fp64; fp32 also at
   64 streams and at the 4**6 edge states) at 2**20 values against their
   plain versions on the same key and state, with parameters reaching
   every branch, and TP and TB also at uniform ones (poisson(37),
   binomial(1000, 0.5)): every differing element counted (0 required),
   device times, bounds (bytes, or the threefry hashes these inputs need,
   at the card's 32-bit integer rate), TP's, TB's and TM's registers,
   local bytes and resident blocks, and PyTorch's own samplers at the same
   parameters as a note.  (k2) one
   ``RandomStream`` and one captured function draw 2**20 values of every
   distribution the loop kernels' slice ported (float64; gamma in float32
   too; Poisson with float32 lambda), 3 calls each bitwise an eager twin's
   with its keys, values fresh each call; the first call's sample mean and
   variance of each parameter group within MOMENT_SE standard errors of
   scipy's, the shuffles checked as permutations.  (k3) MRG31k3p: 2**20
   uniforms (fp32, fp64), normals and binomials from one
   ``MRG_RandomStream`` (15,360 streams, 69 steps), captured against eager,
   states too, and moments.
l. (l) bf16 and fp16 beyond PR 16.  (l1) bench_decode.py's bfloat16 half,
   its calls verbatim (mode "FAST_RUN", floatX bfloat16):
   ``DecoderLM(32000, 4, 512, 8, 2048, seed=0)`` at t_max 512, 256
   greedy tokens, 32 streams x 256 tokens, a 256-token prompt
   (``(arange(256) * 7) % 32000``) then 8, and the int8 copy's 256 greedy
   tokens: K1 on their bf16 Composites, 3 counted calls each (eager,
   capture, replay, the same tokens), tokens/s, host time, peak memory,
   one profiled session ((l1c)'s busy share); tokens against the CPU's
   (streams 0 and 1 against the card's single stream) under the tie rule
   at bf16's spacing, TIE_REL_BF16 of the logits' scale.  (l2) path (f)'s
   LSTM in bfloat16 with adam (float32 moments), 3 counted and 5 timed
   steps, the loss falling; at 8 rows 3 steps each within one bf16
   spacing of plain adam on the gradients the step returned, where the
   gradient is past 2**-8 of its scale (``check_adam_step``), and the first's loss and gradients within
   BF16_REL of the CPU's plus the CPU's own distance from float64, its
   parameters within one spacing of the CPU's where the CPU's gradient is
   past that gate.  (l3) the flagship encoder's sgd step in float16 (K1, K2 and
   K3 in fp16, launches a step), 3 + 10 steps, finite losses; at batch 1
   the gradients within FP16_STEP_REL of the CPU's plus its own distance
   from float64, then the step.  (l4) ``run_model_scale``: 8 x (2048, 16,
   8192) at 8 x 2048 tokens in bfloat16, remat off, 3 + 5 steps, a finite
   falling loss, step ms, tokens/s, peak memory: (i2)'s remat-off arm
   (``run_scale_arm``), run once.  (l5), made with phase 3's
   checks: K2 and K3 alone (``check_attention``) in fp16 at (128, 1024, 64),
   fp32, bf16 and fp16 at (32, 1024, 256), fp32 and bf16 at D 160, and
   fp32 at (65,600, 16, 64), past gridDim.y's 65,535: each against its
   plain version (ATTENTION_REL of the scale), two calls bitwise, device
   ms beside the plain version, scaled_dot_product_attention and its
   fastest backward, and the bound; a causal FusedAttention at D 256 (fp32)
   and in fp16 compiled through ``function()``.
8. captured against eager: every path above (the forward request, the
   sgd and AdamW steps, the classifier step, ``predict`` of one request
   sent again, the GLM's sgd and adam steps, path (c) at width 20, config
   3's step, config 4's step, the LSTM step, (g1) at 16 tokens, (h1)
   with top-k 40 at 16 tokens, (g5)'s
   ``_decode`` at chunk 1 and 16 after 32 admissions, (i1)'s bfloat16
   step and (i3)'s train step on one row after another) compiled
   twice from the same seeds, captured and with ``use_graph=False``, each
   driven alike (4 calls compared, then timed; the captured run also
   profiled, since PR 21 not the eager one); a "capture table" line for
   each gives its step time back to back, host time of one call, device
   busy share (profiled, captured), peak and reserved memory and BLAS
   ops, and the largest difference between the two runs' outputs and
   state (bitwise, or within CAPTURE_REL of each tensor's scale).  A
   captured run's profile is held to its launches as everywhere.

The CPU's side of the card-vs-CPU checks of (d), (g1), (h1), (h3), (i1),
(i3), (l1), (l2) and (l3) is made in a spawned process of its own (CPU_REF_THREADS cores,
no CUDA) while the card runs the paths before them; it ends before the
script.

The next-to-last lines are a JSON object describing the kernels (each
kernel's launches from its path's run, and beside them the launches that
run replayed and those the trace showed in the path's profiled replays;
K1-K3 also with their launches in path 4d's 3 steps, and K1 with its time
and bound on the AdamW update; K1 and K4 with their launches in each
configuration of path (e), (f), (g) and (h), and K4 with its checks there;
the threefry kernel, which replaces no TPU kernel, with (h1)'s launches
and its launches in paths (b) and (h); K1-K4 with their launches in each
run of path (i), K1 with its bfloat16 time and bound, K2 and K3 with their
bfloat16 checks at (i)'s panels, K4 with its check at (i3)'s softmax; K1
and K4 with their launches in (j1)'s counted steps, K4 with its check
there; K1 and K4 with their launches in (k1)'s 3 counted steps, K4 with
its check at (k1)'s (24000, 29); TG, TP, TB and TM, which replace no TPU
kernel, with their launches in (k2)'s or (k3)'s 3 counted calls, their
mismatch counts against the plain versions (0), their times and bounds
and, under ``torch_*_ms``, PyTorch's samplers of the same distributions;
K1-K4 with their launches in each run of path (l), K2 and K3 with their
checks at (l5)'s panels) and the card's name and power limit; the last is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import importlib.util
import io
import json
import os
import re
import statistics
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import scipy.sparse as sps
import torch

N_LAYERS, D_MODEL, N_HEADS, D_FF = 4, 1024, 16, 4096
BATCH, SEQ = 8, 1024
N_REQUESTS = 3
N_COMPOSITE = 5 * N_LAYERS + 1   # see check_graph
N_COMPOSITE_TRAIN = 74           # see check_train_graph
N_TRAIN_STEPS, N_TIMED_STEPS, LR = 3, 10, 0.01
F32_ATOL = 1e-4          # fp32 kernels against fp32 plain versions
BF16_REL = 2e-2          # bf16 error relative to the output's scale
FP16_REL = 2e-3          # fp16 K2/K3 against their plain versions, of the output's scale: results rounded at 2**-11
# K2 and K3 against their plain versions at path (l5)'s panels, of the plain output's scale
ATTENTION_REL = {torch.float32: 1e-4, torch.bfloat16: BF16_REL, torch.float16: FP16_REL}
K3_ATOL, K3_RTOL = 5e-4, 1e-3   # fp32 K3: the JAX package's own bound for its backward
SLICE_TOL = 1e-3         # card against CPU after 4 layers (reduction order)
TRAIN_TOL = 1e-4         # card against CPU after one train step (reduction order)
# path 4d: the AdamW recipe, its Composites (see check_train_graph) and
# its card-vs-CPU check.  Adam divides each gradient entry by its own
# running RMS, so an entry whose gradient sums cancel carries the two
# devices' rounding into the update as a fraction of the learning rate:
# such entries (at most ADAMW_CANCEL_SHARE of a tensor; 0.13% of one
# layer's wq on the H100) may differ by up to two updates' worth, 2 x the
# largest lr of the steps compared
ADAMW_LR, ADAMW_WARMUP, ADAMW_TOTAL = 1e-3, 2, 13
ADAMW_WD, ADAMW_CLIP = 0.01, 1.0
N_COMPOSITE_ADAMW = 197          # see check_train_graph
N_ADAMW_CPU_STEPS = 2
ADAMW_CANCEL_SHARE = 1e-2
GLM_OPT_LR = 1e-3        # the GLM optimizers' learning rate
CAPTURE_REL = 1e-6       # captured against eager, where not bitwise: of each tensor's largest value
N_COMPARED_CALLS = 4     # phase 8: calls whose results captured and eager must share

K1_SOURCE = "aesara_tpu_torch/link/torch/kernels/elemwise.py"
K2_SOURCE = "aesara_tpu_torch/link/torch/kernels/csrc/flash_fwd.cu"
K3_SOURCE = "aesara_tpu_torch/link/torch/kernels/csrc/flash_bwd.cu"
K4_SOURCE = "aesara_tpu_torch/link/torch/kernels/csrc/softmax_rows.cu"
K567_SOURCE = "aesara_tpu_torch/link/torch/kernels/csrc/csr_spmm.cu"
K1_REPLACES = "aesara_tpu/link/jax/pallas_kernels.py:38"
K2_REPLACES = "aesara_tpu/link/jax/pallas_kernels.py:205"
K3_REPLACES = "aesara_tpu/link/jax/pallas_kernels.py:403"
K4_REPLACES = "aesara_tpu/link/jax/pallas_kernels.py:89"
K5_REPLACES = "aesara_tpu/link/jax/bss.py:197"
K6_REPLACES = "aesara_tpu/link/jax/bss.py:271"
K7_REPLACES = "aesara_tpu/link/jax/bss.py:354"
TF_SOURCE = "aesara_tpu_torch/link/torch/kernels/threefry.py"
TF_REPLACES = "none: the JAX package draws by jax.random under XLA (aesara_tpu/link/jax/random_dispatch.py:16-37)"
RL_SOURCE = "aesara_tpu_torch/link/torch/kernels/csrc/random_loops.cu"
RL_REPLACES = {k: f"none: the JAX package draws by {v} under XLA (aesara_tpu/tensor/random/basic.py)"
               for k, v in (("TG", "jax.random.gamma"), ("TP", "jax.random.poisson"),
                            ("TB", "jax.random.binomial"))}
RL_REPLACES["TM"] = "none: the JAX package steps MRG31k3p by lax.scan (aesara_tpu/link/jax/random_dispatch.py:40-137)"

# the least time of a kernel: bytes over the H100's memory rate, flops over
# its rate for the kernel's type: fp32 outside the tensor cores, or dense
# TF32 on them for K2 and K3, which take each fp32 product as three TF32
# ones, or dense bf16 (NVIDIA's data sheet, SXM part)
HBM_BYTES_PER_S = 3.35e12
L2_FLUSH_BYTES = 256 * 2**20     # written before a launch timed cold: five times the 50 MB L2
FP32_FLOPS = 67e12
# 32-bit integer add, logic and shift: 64 results a clock an SM (the CUDA C++
# Programming Guide's arithmetic throughput table, compute capability 9.0)
# on 132 SMs at the 1.98 GHz boost clock
INT32_OPS = 64 * 132 * 1.98e9
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
K2_WALKS = (16, 32, 64)   # walked key tiles --k2-walk-sweep builds
K7_CHUNKS = (64, 128, 256, 512)   # plan chunk sizes --k7-sweep times
K4_ROUNDS, K4_LAUNCHES = 9, 200   # --k4-times: rounds, launches a round
K4_TILES = (32, 64, 128, 256, 512)   # threads a lane-group block --k4-times sweeps
# --k4-times: widths of the regime sweep (each regime that takes the width,
# at K4_SWEEP_VALUES values) and of the width sweep against the library
K4_REGIME_WIDTHS = (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384)
K4_WIDTHS = (20, 100, 1000, 8192, 32768)
K4_SWEEP_VALUES, K4_SWEEP_ROUNDS = 1 << 22, 3

# (a) fetch_20newsgroups_vectorized, training split: 11,314 documents x
# 130,107 features, 20 classes; words per document log-normal, so that a
# document stores about 157 entries once repeated words are merged
NG_DOCS, NG_FEATURES, NG_CLASSES = 11314, 130107, 20
NG_LOG_MU, NG_LOG_SIGMA = 4.85, 1.0
NG_REQUEST_DOCS, NG_CPU_DOCS = 1000, 512
# (b) bench_reference_ratio.py config 5 at REFRATIO_SCALE=4
GLM_N, GLM_D, GLM_DENSITY = 16384, 8192, 0.01
GLM_NOISE_SEED, GLM_NOISE = 42, 0.01     # its eps: RandomStream(seed=42).normal(size=(d,)) * 0.01
SPARSE_LR = 0.1
N_SPARSE_STEPS, N_SPARSE_TIMED = 3, 10
SPLIT_WIDTHS = (1, 2, 4, 8, 16, 32)
GRAD_WIDTHS = (1, 20)
SPARSE_TOL = 1e-5        # fp32 K4-K7 against their plain versions (summation order)
# (e) bench_reference_ratio.py configs 1-3 at REFRATIO_SCALE=4, and the MLP
# at config 3's widths: config 1 16,384 x 784 (sgd 0.1), config 2 8,192 x
# 1,024, config 3 784-512-512-10 at minibatch 512 of 10 (sgd 0.01)
REF_N1, REF_D1, REF_LR1 = 4 * 4096, 784, 0.1
REF_N2, REF_D2 = 4 * 2048, 1024
REF_B, REF_DIN, REF_H, REF_DOUT, REF_NBATCH, REF_LR3 = 4 * 128, 784, 512, 10, 10, 0.01
MLP_LR = 0.1
N_REF_STEPS, N_REF_TIMED = 3, 10
# (f) bench_reference_ratio.py config 4 at REFRATIO_SCALE=4: T 128 steps of
# a (128, 64) input (batch 32 x 4), hidden 128, float32, sgd 0.01; and
# LSTM(64, 128, 10) at its T and batch with adam(lr=1e-3) on an input X
SCAN_T, SCAN_B, SCAN_H, SCAN_DIN, SCAN_LR = 128, 4 * 32, 128, 64, 0.01
LSTM_NOUT, LSTM_LR = 10, 1e-3
N_SCAN_STEPS, N_SCAN_TIMED, N_SCAN_REQUESTS = 3, 10, 3
# (g) benchmarks/bench_decode.py:20-27,63-66: DecoderLM(32000, 4, 512, 8,
# 2048) in float32, 256 greedy tokens from token 17 against caches of 512,
# a prompt of 256 then 8 tokens, 32 streams; bench_serving.py:19-35: vocab
# 2048, 32 slots, t_max 256, t_pad 32, 32 prompts of 16 tokens from
# default_rng(0), 64 new tokens each, chunks 1 and 16
DEC_VOCAB, DEC_LAYERS, DEC_D, DEC_HEADS, DEC_FF = 32000, 4, 512, 8, 2048
DEC_T_MAX, DEC_STEPS, DEC_FIRST, DEC_PROMPT, DEC_NEW, DEC_BATCH = 512, 256, 17, 256, 8, 32
DEC_INT8_COMPARED = 32
SERVE_VOCAB, SERVE_SLOTS, SERVE_T_MAX, SERVE_T_PAD, SERVE_PROMPT, SERVE_NEW = 2048, 32, 256, 32, 16, 64
SERVE_CHUNKS = (1, 16)
N_DEC_CALLS, N_DEC_TIMED = 3, 10
# phase 8: greedy decode of this many tokens (32 before path (h) came, cut
# to keep the run's time), and sampled decode of this many
DEC_CAPTURE_STEPS, SAMPLE_CAPTURE_STEPS = 16, 16
TIE_REL = 1e-3              # a differing token is a tie where the CPU's top-2 gap is under this of the scale
# (h) the decoder's cut features at (g)'s width (the JAX package's
# aesara_tpu/models/decoder.py): sampling at temperature 0.8, alone and with
# top-k 40; speculative decoding of 64 tokens after (g2)'s prompt with a
# one-layer draft of seed 1 and 4 proposals a round, and the target as its
# own draft at 33; beam search of 32 tokens with 4 beams, and of 8 with 1
SAMPLE_T, SAMPLE_TOPK = 0.8, 40
SPEC_NEW, SPEC_N, SPEC_SELF_NEW, SPEC_DRAFT_LAYERS, N_SPEC_CALLS = 64, 4, 33, 1, 3
BEAM_NEW, BEAM, BEAM_ONE_NEW = 32, 4, 8
# (h3) prompts (arange(256) * m) % 32000 for these m: (g2)'s, then two more
BEAM_PROMPT_STRIDES = (7, 13, 31)
# beam score, card against CPU: a sum of 32 log-probabilities in fp64 from
# logits that pass through fp32 projections, which the card sums in
# another order (1.5e-8 relative at (g2)'s prompt in each card run); the
# same tokens' score by an fp32 path (log-softmax and sum in float32) is
# 1.3e-7 off the CPU's there.  The tolerance lies between the two, and the
# run fails if the fp32 path's score would pass it
BEAM_SCORE_REL = 5e-8
TF_SIZES = (1, 31, DEC_VOCAB, 2**20 + 3)   # values of the threefry checks
# the CPU's side of the card-vs-CPU checks of paths (d), (g) and (h) is made
# in a process of its own (cpu_reference) while the card runs the paths
# before them; it takes this many of the host's cores
CPU_REF_THREADS = 3
# 32-bit integer operations of one threefry2x32 hash: 20 rounds of add,
# rotate (one funnel shift) and xor, and 5 key injections of 3 adds
TF_HASH_OPS = 20 * 3 + 5 * 3
# the JAX package's FAST_RUN op counts of path (f)'s two steps at these
# widths, outer graph then each Scan's inner graph, taken on the CPU with
# tests/test_torch_rnn.py's op_counts (its config 4 graph keeps a second,
# identical cast(0) that its merge pass misses, tests/test_torch_rnn.py; it
# is not counted here)
SCAN_JAX_COUNTS = {
    "config4": [
        {"Elemwise{Cast}": 1, "DynamicSlice": 2, "Subtensor": 18, "Alloc": 6, "Shape": 7, "Elemwise{Mul}": 7,
         "MakeVector": 8, "Reshape": 8, "Dot": 5, "DimShuffle": 4, "Scan": 2, "Join": 1, "IncSubtensor": 1,
         "Composite{Add.Add.Sqr.Tanh}": 1, "Composite{Mul.Sub}": 3, "Composite{Add.TrueDiv.TrueDiv}": 1},
        ("ScanInfo(n_seqs=1, mit_sot_taps=(), n_sit_sot=1, n_nit_sot=0, n_shared=0, n_non_seqs=2, as_while=False, "
         "final_only=(), tail_depths=(), nit_tail_depths=())", {"Dot": 1, "Elemwise{Add}": 2, "Elemwise{Tanh}": 1}),
        ("ScanInfo(n_seqs=4, mit_sot_taps=(), n_sit_sot=4, n_nit_sot=1, n_shared=0, n_non_seqs=2, as_while=False, "
         "final_only=(True, True, True, True), tail_depths=(), nit_tail_depths=())",
         {"Subtensor": 1, "Elemwise{Add}": 6, "DimShuffle": 7, "Elemwise{Sub}": 1, "Elemwise{Mul}": 1, "Dot": 4,
          "Elemwise{Second}": 1, "IncSubtensor": 1})],
    "lstm": [
        {"Shape_i": 10, "Alloc": 9, "DimShuffle": 11, "Scan": 2, "Subtensor": 9, "Dot": 3, "Elemwise{Add}": 5,
         "LogSoftmax": 1, "ARange": 1, "Elemwise{Cast}": 2, "AdvancedSubtensor": 1, "Elemwise{TrueDiv}": 1,
         "AdvancedIncSubtensor": 1, "Composite{Exp.Mul.Sub}": 1, "Composite{Add.Mul.Mul}": 8,
         "Composite{Pow.Sub}": 2, "Composite{Add.Mul.Mul.Sqrt.Sub.TrueDiv.TrueDiv}": 4, "Join": 2,
         "IncSubtensor": 1, "Composite{Neg.TrueDiv}": 1},
        ("ScanInfo(n_seqs=1, mit_sot_taps=(), n_sit_sot=2, n_nit_sot=0, n_shared=0, n_non_seqs=2, as_while=False, "
         "final_only=(), tail_depths=(), nit_tail_depths=())",
         {"Elemwise{Cast}": 1, "Join": 1, "Dot": 1, "Elemwise{Add}": 2, "Subtensor": 4, "Elemwise{Sigmoid}": 3,
          "Elemwise{Mul}": 3, "Elemwise{Tanh}": 2}),
        ("ScanInfo(n_seqs=5, mit_sot_taps=(), n_sit_sot=4, n_nit_sot=1, n_shared=0, n_non_seqs=3, as_while=False, "
         "final_only=(True, True, True, True), tail_depths=(), nit_tail_depths=())",
         {"Elemwise{Cast}": 1, "Join": 1, "Dot": 3, "Elemwise{Add}": 12, "DimShuffle": 15, "Elemwise{Second}": 6,
          "Subtensor": 8, "Elemwise{Sigmoid}": 6, "Elemwise{Mul}": 16, "Elemwise{Tanh}": 4, "Elemwise{Sub}": 5,
          "IncSubtensor": 6, "Elemwise{Sqr}": 2, "Shape": 2, "MakeVector": 1, "Split": 1})],
}
# (i) bench_transformer.py's bfloat16 row (:70-71,147-166: the flagship
# encoder above in bfloat16, 3 + 10 steps); run_model_scale_remat
# (:103-121): 12 layers of (2048, 16, 8192) at B 8 x T 2048 in bfloat16, here
# 8 deep since PR 21 (the smoke's 1,200 s take path (l); run_model_scale's depth),
# remat off then on, 3 counted steps and N_SCALE_TIMED timed ones each (the
# bench times 10); K2 and K3 in bfloat16 at the two paths' panels; and
# examples/production_training.py at (g)'s width: rows of 257 tokens from
# default_rng(0), 16 rows x 2 epochs, its AdamW, schedule and loss scaling,
# then 8 tokens of the resumed model from token 1 against caches of 16
SCALE_LAYERS, SCALE_D, SCALE_HEADS, SCALE_FF, SCALE_BATCH, SCALE_SEQ = 8, 2048, 16, 8192, BATCH, 2048
N_SCALE_TIMED = 5
BF16_PANELS = ((BATCH * N_HEADS, SEQ, D_MODEL // N_HEADS),
               (SCALE_BATCH * SCALE_HEADS, SCALE_SEQ, SCALE_D // SCALE_HEADS))
TRAIN_ROWS, TRAIN_ROW_LEN, TRAIN_EPOCHS = 16, 257, 2
TRAIN_LR_MAX, TRAIN_WARMUP, TRAIN_TOTAL, TRAIN_WD = 3e-3, 20, 200, 0.01
# (i3) against the CPU: every state variable after the first step at
# TRAIN_TOL, and the losses of the first TRAIN_CPU_STEPS steps within
# TRAIN_LOSS_REL of the CPU's (the port's are held to the JAX package's so on
# the CPU, tests/test_torch_production_training.py; AdamW moves an entry
# whose gradient sums cancel by up to 2 lr a step, so later losses drift)
TRAIN_CPU_STEPS, TRAIN_LOSS_REL = 8, 1e-3
GEN_STEPS, GEN_T_MAX = 8, 16
# (j) LeNet's widths (the Aesara/Theano tutorial's convolutional_mlp.py,
# evaluate_lenet5: nkerns [20, 50], batch 500, learning rate 0.1, 28 x 28
# MNIST images) on the JAX package's ConvNet (3 x 3 "half" convolutions,
# ReLU, 2 x 2 max-pools), float32; the images are synthetic at MNIST's
# shape, from SEED (``--seed``), as MNIST is not in the repository
CONV_CHANNELS, CONV_HW, CONV_CLASSES, CONV_BATCH, CONV_LR = (20, 50), (28, 28), 10, 500, 0.1
CONV_CPU_BATCH, CONV_REQUESTS = 8, 3
N_CONV_STEPS, N_CONV_TIMED = 3, 10
# (k) Deep Speech 2 (Amodei et al. 2016, arXiv:1512.02595), English: 28
# characters and the blank, C = 29; 15 s of audio at a 10 ms hop after a
# stride of 2, T = 750 frames; B = 32 utterances of 600-750 frames, labels
# of 150-200 characters padded with -1 to L = 200, a share CTC_REPEAT of
# them repeating the one before; a linear CTC head on D = 1024 features,
# sgd.  The card's loss and gradients against the CPU's within CTC_TOL of
# each tensor's largest value (fp32 products and the DP's sums in another
# order)
CTC_T, CTC_B, CTC_C, CTC_L, CTC_D, CTC_LR = 750, 32, 29, 200, 1024, 0.01
CTC_ILEN, CTC_LLEN, CTC_REPEAT = (600, 750), (150, 200), 0.15
CTC_TOL = 1e-4
N_CTC_STEPS, N_CTC_TIMED = 3, 10
# (k2) and (k3): 2**20 values a draw, MRG31k3p's guessed streams for them
# (guess_n_streams: 15,360, 69 steps), 3 calls; moments within MOMENT_SE
# standard errors; MRG_STEP_OPS integer operations a stream step (two
# multiply-adds and a modulo a component, the difference and its wrap)
RAND_N, MRG_STREAMS, N_RANDOM_CALLS, MOMENT_SE, MRG_STEP_OPS = 1 << 20, 15360, 3, 6.0, 10
# TM's rows beside (k3)'s: the streams a user may pass (``nstreams``), and
# MRG31k3p's moduli, whose edges make the edge states
MRG_FEW_STREAMS, MRG_M1, MRG_M2 = 64, 2147483647, 2147462579
# --mrg-times: TM's rows (label, streams or None for guess_n_streams,
# values, dtype) and the chunk lengths its sweep launches
MRG_TIME_ROWS = (("2**20 values, 15,360 streams", MRG_STREAMS, 1 << 20, "float32"),
                 ("2**20 values, 15,360 streams", MRG_STREAMS, 1 << 20, "float64"),
                 ("2**24 values, 15,360 streams", MRG_STREAMS, 1 << 24, "float32"),
                 (f"2**20 values, {MRG_FEW_STREAMS} streams", MRG_FEW_STREAMS, 1 << 20, "float32"),
                 ("1,000 values, guessed streams", None, 1000, "float32"),
                 ("92,160 values, guessed streams", None, 92160, "float32"))
MRG_SWEEP_CHUNKS = (4, 8, 16, 32, 64)
LOOP_TIME_ROUNDS = 3        # --loop-times: profiled sessions a row
# --loop-times: TP's and TB's small draws (values), timed as calls in a
# CUDA graph; a multinomial of MULTINOMIAL_DRAWS draws over
# MULTINOMIAL_P's categories, a scan of TB
LOOP_SMALL_N, LOOP_GRAPH_CALLS = (1, 256, 4096), 50
MULTINOMIAL_DRAWS, MULTINOMIAL_COUNT = 256, 100.0
MULTINOMIAL_P = (0.02, 0.05, 0.08, 0.1, 0.15, 0.2, 0.1, 0.12, 0.1, 0.08)
SEED = 0
PROFILE_STEPS = 3        # calls counted in a profiled window, after one the profiler drops and a lead-in
N_HOST_CALLS = 5         # calls whose host time time_steps takes the median of
# host time at each edge of a profiled window.  On the H100, once the card
# has run hot, the trace's device timestamps lose up to all of a stretch
# in which the card idles, so a kernel next to an idle edge can land
# outside the window (PERF.md §7).  The card therefore spins through the
# edges (torch.cuda._sleep, SPIN_CYCLES_PER_S cycles a second): see
# spin_edge
PROFILE_GAP_S = 0.1
# the markers between a profiled window's lead-in call and its counted
# calls: N_MARKERS spins of MARKER_S seconds each, told from the edges'
# spins (gap / 2 and more) by lasting less than MARKER_LIMIT_S.  The trace
# may lose the first records of a window (PERF.md §7), a lone marker too
N_MARKERS, MARKER_S, MARKER_LIMIT_S = 16, 5e-5, 1e-2
SPIN_CYCLES_PER_S = 1.98e9     # the H100 SXM's top SM clock
PROFILE_LOAD_S = 15            # --profile-check: seconds of GEMMs before each round
# sessions a profile may take before its trace must show every launch:
# without a lead-in, a window lost the first call's K6 record in some
# sessions of predict and in all 6 of one run (PERF.md §7)
PROFILE_ATTEMPTS = 6


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def spin(seconds: float):
    """Keep the card busy for at least ``seconds`` (``spin_kernel``, left
    out of the device events), or longer at a lower clock."""
    torch.cuda._sleep(int(seconds * SPIN_CYCLES_PER_S))


def spin_edge(opening: bool, gap: float = PROFILE_GAP_S):
    """``gap`` seconds of host time at an edge of a profiled window, the
    card spinning through at least the first half of an opening edge (so
    that the first call does not wait for it at clocks down to half the
    top one) and through all of a closing edge."""
    spin(gap / 2 if opening else gap)
    time.sleep(gap)


def device_events(prof) -> list:
    """A trace's device events but the profiler's own ProfilerStep# ranges
    (annotations, not work) and spin_edge's kernel."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith("ProfilerStep") and "spin_kernel" not in e.name]


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call of ``fn`` by CUDA events around it.  For a
    short kernel this is bounded by the host's launch cost, not by the
    device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_split(fn, reps: int = 20, warmup: int = 3, census=None) -> dict:
    """Device time of one call of ``fn`` by kernel name: the summed
    duration of the kernels (and copies) it runs on the card, by
    torch.profiler (CUPTI), averaged over ``reps`` calls; ``census``, a
    dict, gains the device events a call under "events"."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_ATTEMPTS):
        # on the H100 a profiler session now and then comes back without
        # device events, several in a row late in a long run; try it again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            # the card spins through the whole opening edge, so the first
            # launch follows no idle stretch (whose time the trace can lose
            # on a hot card, and the launches with it)
            spin(1.5 * PROFILE_GAP_S)
            time.sleep(PROFILE_GAP_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            spin_edge(opening=False)
        device = device_events(prof)
        if device:
            break
        spins = sum("spin_kernel" in e.name for e in prof.events())
        log(f"profiler session {attempt + 1} saw no device activity ({spins} spin kernels in its trace)")
    else:
        raise RuntimeError(f"the profiler saw no device activity in {PROFILE_ATTEMPTS} sessions")
    by_name: dict = {}
    for e in device:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / reps / 1e3
    if census is not None:
        census["events"] = len(device) / reps
    return by_name


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn`` (see ``device_split``)."""
    return sum(device_split(fn, reps, warmup).values())


def release():
    """Free what dropped functions held: a Function refers to itself, so
    its captured graphs and their memory pools go with a collection."""
    gc.collect()
    torch.cuda.empty_cache()


def reset_peak():
    """Start a peak-memory window; garbage left by the checks before it
    (tensors in reference cycles) is collected first, so it does not count."""
    gc.collect()
    torch.cuda.reset_peak_memory_stats()


def bound(n_bytes: float, flops: float, flops_per_s: float = FP32_FLOPS):
    """(least ms, what bounds it): the larger of the bytes over the card's
    memory rate and the flops over its rate for the kernel's type (fp32
    outside the tensor cores unless given)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def library_split(name: str, fn):
    """(device ms, names of the device kernels) of one PyTorch library call
    computing a kernel's function, the yardstick of PERF.md (the port never
    calls it); (None, []), with the reason logged, when the library refuses
    these inputs."""
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            split = device_split(fn)
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        log(f"{name} library call not timed: {type(exc).__name__}: {str(exc)[:200]}")
        return None, []
    return sum(split.values()), sorted(split)


def library_ms(name: str, fn):
    """Device ms of ``library_split``."""
    return library_split(name, fn)[0]


def call_by_schema(op, values: dict):
    """A call of the aten overload ``op``, each argument passed by the name
    that the installed torch's schema gives it, from ``values``; one that
    ``values`` lacks keeps its default (a TypeError if it has none)."""
    kwargs = {}
    for arg in op._schema.arguments:
        if arg.name in values:
            kwargs[arg.name] = values[arg.name]
        elif not arg.has_default_value():
            raise TypeError(f"{op._schema.name}: no value for its argument {arg.name}")
    return lambda: op(**kwargs)


def build_encoder(device: str):
    import aesara_tpu_torch.tensor as pt
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models.transformer import TransformerEncoderLayer
    from aesara_tpu_torch.tensor import math as tm

    with config.change_flags(device=device, floatX="float32"):
        layers = [TransformerEncoderLayer(D_MODEL, N_HEADS, D_FF, seed=i) for i in range(N_LAYERS)]
    x = pt.tensor3("x")
    h = x
    for layer in layers:
        h = layer(h)
    return layers, x, [h, tm.mean(tm.sqr(h))]


def compile_encoder(device: str, use_graph=None):
    import aesara_tpu_torch as ptp

    _, x, outs = build_encoder(device)
    return ptp.function([x], outs, mode=ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph)))


def composite_nodes(fn):
    """The Composite nodes of a compiled function that run on the card
    (one K1 launch each): those the linker does not fold on the host."""
    from aesara_tpu_torch.scalar.composite import Composite

    program = fn.fn.program
    return [n for n, fold in zip(program.order, program.folds)
            if not fold and isinstance(getattr(n.op, "scalar_op", None), Composite)]


BLAS_OPS = ("Gemm", "Gemv", "Ger", "Dot22", "Dot22Scalar")


def blas_counts(fn) -> str:
    """The BLAS ops of a compiled function's graph, by op, and its Dots."""
    names = [type(n.op).__name__ for n in fn.maker.fgraph.toposort()]
    return ", ".join(f"{op} {names.count(op)}" for op in BLAS_OPS + ("Dot",))


def require_captured(fn, label: str, captured: bool = True):
    """Raise unless the last call of ``fn`` replayed a captured CUDA graph
    (or, with ``captured`` False, did not)."""
    log(f"{label}: last call {'replayed a captured CUDA graph' if fn.captured else 'ran eagerly'} "
        f"(blocker: {fn.capture_blocker}; captured keys {fn.fn.n_graphs})")
    if fn.captured != captured:
        raise AssertionError(f"{label}: the last call was {'' if fn.captured else 'not '}captured")


def guarded_inputs(comp):
    """Indices of the Composite's inputs that reach a sqrt's argument or a
    divisor; only these need positive values."""
    from aesara_tpu_torch.scalar.ops import Sqrt, TrueDiv

    guarded = set()
    for node in reversed(comp.nodes):
        if isinstance(node.op, Sqrt):
            guarded.add(node.inputs[0])
        elif isinstance(node.op, TrueDiv):
            guarded.add(node.inputs[1])
        if any(o in guarded for o in node.outputs):
            guarded.update(node.inputs)
    return {i for i, var in enumerate(comp.inputs) if var in guarded}


def composite_inputs(node, rng, device, full=(BATCH, SEQ, D_MODEL), sample="signed", shapes=None):
    """Test values for one Composite node at full width: static-1 dims stay
    1 (they broadcast), unknown dims become ``full``.  Inputs that reach a
    sqrt or a divisor are positive; the others take both signs, so
    ``maximum(., 0)`` takes both of its branches.  With ``sample`` "unit"
    every float input lies in (0.05, 0.95).  ``shapes``, where given, are
    the inputs' shapes (those a run gave them)."""
    guarded = guarded_inputs(node.op.scalar_op)
    out = []
    for i, var in enumerate(node.inputs):
        shape = (tuple(s if s is not None else full[d] for d, s in enumerate(var.type.shape)) if shapes is None
                 else shapes[i])
        if var.type.dtype == "bool":
            arr = rng.random(size=shape) < 0.5
        elif var.type.dtype.startswith("int"):
            arr = rng.integers(1, 100, size=shape)
        elif sample == "unit":
            arr = rng.uniform(0.05, 0.95, size=shape)
        elif i in guarded:
            arr = rng.uniform(0.5, 2.0, size=shape)
        else:
            arr = rng.normal(size=shape)
        out.append(card_tensor(arr, var.type.dtype, device))
    return out


def phase_setup():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
    if importlib.util.find_spec("aesara_tpu_torch") is None:
        raise SystemExit("chip_smoke: the package aesara_tpu_torch is not here; run this script "
                         "from the root of a checkout of the repo")
    # Dot is a full-fp32 product, as in the JAX reference, and a bfloat16 or
    # float16 one sums in fp32: the linker refuses TF32 and the reduced-
    # precision reductions PyTorch turns on by default
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    smi = card_line()
    log(f"card: {smi}; python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}")
    from aesara_tpu_torch.link.torch.kernels import attention, random_loops, softmax, sparse

    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:      # one nvcc per source, started together
        builds = [pool.submit(attention._library, "flash_fwd"), pool.submit(attention._library, "flash_bwd"),
                  pool.submit(softmax._library), pool.submit(sparse._library), pool.submit(random_loops._library)]
        for b in builds:
            b.result()
    log(f"K2 + K3 + K4 + K5-K7 + TG/TP/TB/TM nvcc builds + load: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    warm_k1()
    log(f"K1 Triton compile + first launch (bias+ReLU Composite): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    warm_k4()
    log(f"K4 (CUDA) first launch (log-softmax of 4 x 5): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    warm_tf()
    log(f"threefry Triton compile + first launch (1,000 float64 values): {time.perf_counter() - t0:.2f} s")
    return smi


def warm_k1():
    """Compile and launch one generated K1 kernel on a small input."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch.link.torch.kernels.elemwise import fused_elemwise
    from aesara_tpu_torch.tensor import math as tm
    from aesara_tpu_torch.tensor.type import TensorType

    y = TensorType("float32", (None, None, None))("y")
    b = TensorType("float32", (1, 1, None))("b")
    fn = ptp.function([y, b], tm.maximum(tm.add(y, b), 0.0),
                      mode=ptp.Mode(ptp.TorchLinker(device="cuda")))
    before = fused_elemwise.launches
    out = fn(np.ones((2, 3, 4), "float32"), -np.ones((1, 1, 4), "float32"))
    torch.cuda.synchronize()
    if fused_elemwise.launches != before + 1 or float(out.abs().max()) != 0.0:
        raise AssertionError("K1 warm-up did not launch or gave a wrong result")


def warm_k4():
    """Compile and launch K4 on a small input."""
    from aesara_tpu_torch.link.torch.kernels.softmax import softmax_rows, softmax_rows_plain

    x = torch.randn((4, 5), device="cuda")
    before = softmax_rows.launches
    out = softmax_rows(x, log=True)
    torch.cuda.synchronize()
    if softmax_rows.launches != before + 1 or not torch.allclose(out, softmax_rows_plain(x, True), atol=1e-5):
        raise AssertionError("K4 warm-up did not launch or gave a wrong result")


def warm_tf():
    """Compile and launch the threefry kernel on a small draw, held bitwise
    against its plain version and the host's next key."""
    from aesara_tpu_torch.link.torch.kernels.threefry import threefry_draw, threefry_plain
    from aesara_tpu_torch.tensor.random.op import prng_key, split

    key = torch.as_tensor(prng_key(0)).cuda()
    before = threefry_draw.launches
    nk, u = threefry_draw(key, (1000,), "float64")
    pk, want = threefry_plain(key, (1000,), "float64")
    torch.cuda.synchronize()
    if (threefry_draw.launches != before + 1 or not torch.equal(u, want)
            or not np.array_equal(nk.cpu().numpy(), split(prng_key(0))[0])):
        raise AssertionError("threefry warm-up did not launch or gave a wrong result")


def k1_and_plain_ms(kernel, comp, out_dtype, args) -> tuple:
    """Device ms of one K1 launch and of its plain version on ``args``, from
    one profiled session that runs both (K1's Triton kernel is the one
    named "kernel", ``kernel_group``; the plain version's are PyTorch's)."""
    from aesara_tpu_torch.link.torch.kernels.elemwise import composite_plain, fused_elemwise

    split = device_split(lambda: (fused_elemwise(kernel, *args), composite_plain(comp, out_dtype, *args)))
    ms = sum(t for name, t in split.items() if kernel_group(name) == "K1 fused Composite")
    return ms, sum(split.values()) - ms


def k1_rel_gate(comp, out_dtype: str):
    """The gate of a Composite that rounds to 16 bits, relative to its
    output's scale, or None for F32_ATOL: BF16_REL where its output is
    bfloat16 (or float16 from a bfloat16 chain), FP16_REL where it rounds
    to float16 anywhere (``cast{float32}`` of an fp16 chain: one fp16
    spacing of a step of the chain reaches the float32 output).  A 32- or
    64-bit output of a bfloat16 chain keeps F32_ATOL: the two forms round
    such chains alike at the paths' inputs."""
    inside = {out_dtype} | {n.outputs[0].type.dtype for n in comp.nodes}
    if "bfloat16" in (inside if out_dtype in ("bfloat16", "float16") else ()):
        return BF16_REL
    return FP16_REL if "float16" in inside else None


def phase_k1(fn, rng, skip=(), timed_shape=(BATCH, SEQ, D_MODEL), full=(BATCH, SEQ, D_MODEL),
             time_each: bool = True):
    """K1 on each distinct Composite that the compiled ``fn`` runs on the
    card (but those in ``skip``)
    against its plain version: (max abs err of the float32 and float64
    Composites, max err of those that compute in bfloat16 or float16
    (``k1_rel_gate``) relative to their output's scale (their gate), (ms, plain ms, bound ms, bound by, ms with
    the L2 flushed) of the Composite of the most ops (more than two) whose
    output has ``timed_shape``, or None, the Composite ops checked); each
    Composite is timed unless ``time_each`` is off."""
    from aesara_tpu_torch.link.torch.kernels.elemwise import (
        ElemwiseKernel, composite_plain, fused_elemwise,
    )

    device = torch.device("cuda")
    k1_err, rel_err, k1_times, timed = 0.0, 0.0, None, []
    distinct = []     # one node of each Composite op, one with ``timed_shape`` where there is one
    for node in composite_nodes(fn):
        if node.op in skip:
            continue
        known = [i for i, n in enumerate(distinct) if n.op == node.op]
        if not known:
            distinct.append(node)
        elif timed_shape is not None and node.outputs[0].type.shape == tuple(timed_shape):
            distinct[known[0]] = node
    for node in distinct:
        comp = node.op.scalar_op
        out_dtype = node.outputs[0].type.dtype
        kernel = ElemwiseKernel(comp, [v.type.dtype for v in node.inputs], out_dtype)
        args = composite_inputs(node, rng, device, full)
        t0 = time.perf_counter()
        got = fused_elemwise(kernel, *args)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
        want = composite_plain(comp, out_dtype, *args)
        err = (got.double() - want.double()).abs().max().item()
        low, scale = k1_rel_gate(comp, out_dtype), want.double().abs().max().item()
        tol = F32_ATOL if low is None else low * scale
        if not err <= tol or got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"K1 {comp} {tuple(got.shape)} {got.dtype}: max err {err} > {tol}")
        if low is not None:
            rel_err = max(rel_err, err / scale if scale else err)
        else:
            k1_err = max(k1_err, err)
        shapes = [tuple(a.shape) for a in args]
        if not time_each:
            log(f"K1 {comp} inputs {shapes} -> {tuple(got.shape)} {out_dtype}: max_abs_err {err:.3e}; first call "
                f"{compile_s:.2f} s")
            continue
        ms, plain_ms = k1_and_plain_ms(kernel, comp, out_dtype, args)
        call, plain_call = (call_ms(lambda: fused_elemwise(kernel, *args)),
                            call_ms(lambda: composite_plain(comp, out_dtype, *args)))
        log(f"K1 {comp} inputs {shapes} -> {tuple(got.shape)} {out_dtype}: max_abs_err {err:.3e}, "
            f"device ms kernel {ms:.4f} plain {plain_ms:.4f}; per call ms kernel {call:.4f} "
            f"plain {plain_call:.4f}; first call {compile_s:.2f} s")
        if timed_shape is not None and tuple(got.shape) == tuple(timed_shape) and len(comp.nodes) > 2:
            timed.append((len(comp.nodes), ms, plain_ms, kernel, args, got))
    if timed:
        # the largest Composite at ``timed_shape``: its time beside its bound,
        # and its time with the L2 cache flushed before each launch, as a
        # train step finds its optimizer state
        _, ms, plain_ms, kernel, args, got = max(timed, key=lambda t: t[0])
        n_bytes = sum(a.numel() * a.element_size() for a in args) + got.numel() * got.element_size()
        k1_times = (ms, plain_ms, *bound(n_bytes, got.numel() * len(kernel.composite.nodes)))
        flush = torch.empty(L2_FLUSH_BYTES // 4, device=device)

        def cold():
            flush.zero_()
            fused_elemwise(kernel, *args)

        cold_ms = device_split(cold)["kernel"]
        log(f"K1 {kernel.composite} {tuple(got.shape)} (the timed one): device ms {ms:.4f}, with the L2 "
            f"flushed before each launch {cold_ms:.4f}; bound {k1_times[2]:.4f} ms ({k1_times[3]}), "
            f"{n_bytes / 1e6:.1f} MB moved")
        k1_times += (cold_ms,)
        del flush
    return k1_err, rel_err, k1_times, {n.op for n in distinct}


def k2_occupancy(lib=None, label: str = "K2 occupancy"):
    """Log the resources of K2's variants from flash_fwd_kernel_info:
    threads, dynamic shared memory, registers, spill bytes, resident blocks
    an SM and walked rows, for each dtype and D variant of ``lib`` (the
    default build unless given)."""
    import ctypes
    from aesara_tpu_torch.link.torch.kernels.attention import _library

    info_fn = (lib or _library("flash_fwd")).flash_fwd_kernel_info
    info_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    info_fn.restype = ctypes.c_int
    for dtype, dtype_name in ((0, "fp32"), (1, "bf16"), (2, "fp16")):
        for dmax in (64, 128, 256):
            info = (ctypes.c_int * 6)()
            err = info_fn(dtype, dmax, info)
            if err != 0:
                raise RuntimeError(f"flash_fwd_kernel_info({dtype}, {dmax}) failed: {err}")
            threads, smem, regs, spill, blocks, walk = list(info)
            log(f"{label} {dtype_name} D<={dmax}: {threads} threads, {smem} B shared, {regs} registers, "
                f"{spill} B spilled, {blocks} blocks ({blocks * threads // 32} warps) an SM, "
                f"walked tiles of {walk} keys")


def sdpa_backend(names) -> str:
    """Which of scaled_dot_product_attention's backends ran, from the names
    of the device kernels it launched."""
    joined = " ".join(names).lower()
    for key, backend in (("cudnn", "cuDNN"), ("flash", "flash"), ("fmha", "memory-efficient (cutlass fmha)"),
                         ("efficient", "memory-efficient")):
        if key in joined:
            return backend
    return "math (unfused)"


def phase_kernels(fn):
    from aesara_tpu_torch.link.torch.kernels.attention import attention_plain, flash_attention

    log(f"tolerances: fp32 max_abs_err <= {F32_ATOL}; bf16 <= {BF16_REL} x max|plain|; "
        f"lse <= {F32_ATOL}")

    rng = np.random.default_rng(0)
    device = torch.device("cuda")
    k1_err, _, k1_times, _ = phase_k1(fn, rng)   # k1_times: the layer-norm scale Composite
    if k1_times is None:
        raise AssertionError("no layer-norm scale Composite among the forward's Composites")

    k2_occupancy()
    k2_err, k2_times = 0.0, None
    gen = torch.Generator(device=device).manual_seed(0)
    # the flagship's panels; a T that is no multiple of the walked tile;
    # rows of no 16-byte multiple (padded by the wrapper); D = 128
    cases = [((128, 1024, 64), False, torch.float32), ((128, 1024, 64), True, torch.float32),
             ((128, 1024, 64), False, torch.bfloat16), ((128, 1024, 64), True, torch.bfloat16),
             ((6, 1000, 40), True, torch.float32), ((2, 130, 33), False, torch.float32),
             ((2, 75, 37), True, torch.bfloat16), ((4, 200, 128), True, torch.float32),
             ((4, 200, 128), False, torch.bfloat16)]
    for shape, causal, dtype in cases:
        q, k, v = (torch.randn(shape, device=device, generator=gen).to(dtype) for _ in range(3))
        scale = 1.0 / shape[-1] ** 0.5
        got, lse = flash_attention(q, k, v, causal=causal, scale=scale, with_lse=True)
        torch.cuda.synchronize()
        want, want_lse = attention_plain(q, k, v, causal, scale, with_lse=True)
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"K2 {shape} {dtype}: {tuple(got.shape)} {got.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        if dtype == torch.float32:
            ok = err <= F32_ATOL and lse_err <= F32_ATOL
            k2_err = max(k2_err, err)
        else:
            ok = err <= BF16_REL * want.float().abs().max().item() and lse_err <= F32_ATOL
        if not ok:
            raise AssertionError(f"K2 {shape} causal={causal} {dtype}: max err {err}, lse err {lse_err}")
        ms = device_ms(lambda: flash_attention(q, k, v, causal=causal, scale=scale))
        plain_ms = device_ms(lambda: attention_plain(q, k, v, causal, scale))
        call = call_ms(lambda: flash_attention(q, k, v, causal=causal, scale=scale))
        log(f"K2 {shape} causal={causal} {str(dtype).split('.')[-1]}: max_abs_err {err:.3e}, "
            f"lse_err {lse_err:.3e}, device ms kernel {ms:.4f} plain {plain_ms:.4f}; "
            f"per call ms kernel {call:.4f}")
        if shape == (128, 1024, 64) and not causal:
            BH, T, D = shape
            again, again_lse = flash_attention(q, k, v, causal=causal, scale=scale, with_lse=True)
            torch.cuda.synchronize()
            if not (torch.equal(got, again) and torch.equal(lse, again_lse)):
                raise AssertionError(f"K2 {shape} {dtype}: two calls gave different bits")
            sdpa, names = library_split("K2", lambda: torch.nn.functional.scaled_dot_product_attention(
                q[None], k[None], v[None], scale=scale))
            backend = sdpa_backend(names)
            ratio = f"{ms / sdpa:.3f}x the library's time" if sdpa else "library not timed"
            log(f"K2 {shape} {str(dtype).split('.')[-1]}: two calls give the same bits (output, lse); "
                f"scaled_dot_product_attention (library, {backend} backend: {', '.join(names)}) "
                f"device ms {sdpa}: {ratio}")
            if dtype == torch.float32:
                # inputs q, k, v and the output; the two products, each taken
                # as three TF32 products on the tensor cores
                k2_bound = bound(4 * q.numel() * 4, 3 * 4 * BH * T * T * D, TF32_FLOPS)
                fp32_ms = 4 * BH * T * T * D / FP32_FLOPS * 1e3
                log(f"K2 {shape} fp32: 3xTF32 bound at {TF32_FLOPS / 1e12:.0f} TFLOP/s {k2_bound[0]:.4f} ms "
                    f"(the kernels line's); the same products in fp32 on the CUDA cores {fp32_ms:.4f} ms")
                k2_times = (ms, plain_ms, *k2_bound, sdpa)
            else:
                log(f"K2 {shape} bf16: bound of the two products at {BF16_FLOPS / 1e12:.0f} TFLOP/s "
                    f"{4 * BH * T * T * D / BF16_FLOPS * 1e3:.4f} ms")
    return k1_err, k1_times, k2_err, k2_times


def check_graph(fn):
    """The rewritten forward holds the fused nodes the kernels serve: per
    layer two layer-norm centres, two layer-norm scales and one bias+ReLU,
    plus the tail of ``mean`` (its sum of squares is one dot since
    ``local_sumsqr2dot``, and the size it divides by one more Composite,
    folded on the host); and one FusedAttention per layer."""
    fgraph = fn.maker.fgraph
    n_composite = len(composite_nodes(fn))
    n_attention = sum(type(n.op).__name__ == "FusedAttention" for n in fgraph.toposort())
    log(f"slice graph: {len(fgraph.toposort())} nodes, {n_composite} Composite on the card, "
        f"{n_attention} FusedAttention; {blas_counts(fn)}")
    if n_composite != N_COMPOSITE or n_attention != N_LAYERS:
        raise AssertionError(f"{n_composite} Composite and {n_attention} FusedAttention nodes, "
                             f"expected {N_COMPOSITE} and {N_LAYERS}")


def phase_slice(fn):
    requests = [np.random.default_rng(100 + r).normal(size=(BATCH, SEQ, D_MODEL)).astype("float32")
                for r in range(N_REQUESTS)]
    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    results, latencies = [], []
    for x in requests:
        t0 = time.perf_counter()
        h, msq = fn(x)
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
        results.append((h, msq))
    launches, _ = read_counters({"K1": N_COMPOSITE, "K2": N_LAYERS}, "forward", N_REQUESTS)
    require_captured(fn, "forward")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log(f"request latency ms: {[round(t, 3) for t in latencies]} (first includes kernel compiles)")
    log(f"peak device memory: {peak_gib:.3f} GiB")
    for h, msq in results:
        if not (h.is_cuda and msq.is_cuda and tuple(h.shape) == (BATCH, SEQ, D_MODEL)
                and h.dtype == torch.float32 and bool(torch.isfinite(h).all())
                and bool(torch.isfinite(msq))):
            raise AssertionError("slice output not finite float32 (8, 1024, 1024) on cuda")
    return requests, results, launches


def profile_request(fn, x):
    """Device busy time and its split by kernel for one request whose
    input already lies on the card."""
    x = torch.as_tensor(x, device="cuda")
    fn(x)
    torch.cuda.synchronize()
    profile_call(lambda: fn(x), "request (input on the card)")
    t0 = time.perf_counter()
    fn(x)
    enqueue = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn(x)
    torch.cuda.synchronize()
    log(f"host time to enqueue one request: {enqueue:.3f} ms; 10 requests back to back: "
        f"{(time.perf_counter() - t0) * 1e2:.3f} ms each")


def steady_latency(fn, requests, n: int = 12):
    """Host-clock latency of ``n`` more requests from NumPy, each ending in
    a synchronise: (median, first quartile, third quartile) in ms."""
    times = []
    for i in range(n):
        t0 = time.perf_counter()
        fn(requests[i % len(requests)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    return statistics.median(times), times[n // 4], times[(3 * n) // 4]


def check_against_cpu(requests, results):
    fn_cpu = compile_encoder("cpu")
    h_cpu, _ = fn_cpu(requests[0][:1])
    h_gpu = results[0][0][:1].cpu()
    err = (h_gpu.double() - h_cpu.double()).abs().max().item()
    log(f"request 1, sequence 1: card vs CPU max_abs_err {err:.3e}")
    torch.testing.assert_close(h_gpu, h_cpu, atol=SLICE_TOL, rtol=SLICE_TOL)


def build_train_step(device: str, batch: int = BATCH, optimizer: str = "sgd", use_graph=None):
    """The flagship train step: the 4-layer encoder on a shared ``x``
    (normal × 0.1 from a seed, its first ``batch`` sequences), loss
    mean(h²), the loss returned on the card (``Out(borrow=True)``), and
    ``sgd`` updates of every parameter or the AdamW recipe (warmup-cosine
    schedule on a shared step counter ``s``, weight decay, global-norm
    clipping): (step, parameters, every update target)."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models.optim import adamw, sgd, warmup_cosine
    from aesara_tpu_torch.models.transformer import TransformerEncoderLayer
    from aesara_tpu_torch.tensor import math as tm

    xv = (np.random.default_rng(200).normal(size=(BATCH, SEQ, D_MODEL)) * 0.1).astype("float32")
    with config.change_flags(device=device, floatX="float32"):
        layers = [TransformerEncoderLayer(D_MODEL, N_HEADS, D_FF, seed=i) for i in range(N_LAYERS)]
        x = ptp.shared(xv[:batch], name="x")
        s = ptp.shared(np.asarray(0.0, dtype="float32"), name="s")
    h = x
    for layer in layers:
        h = layer(h)
    loss = tm.mean(tm.sqr(h))
    params = [p for layer in layers for p in layer.params]
    if optimizer == "sgd":
        updates = sgd(loss, params, lr=LR)
    else:
        lr = warmup_cosine(s, ADAMW_LR, ADAMW_WARMUP, ADAMW_TOTAL)
        updates = adamw(loss, params, lr=lr, weight_decay=ADAMW_WD, grad_clip=ADAMW_CLIP) + [(s, s + 1.0)]
    step = ptp.function([], ptp.Out(loss, borrow=True), updates=updates,
                        mode=ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph)))
    return step, params, [t for t, _ in updates]


def check_train_graph(fn, n_expected: int = N_COMPOSITE_TRAIN, label: str = "train"):
    """The rewritten train step holds one FusedAttention and one
    FusedAttentionGrad per layer, and the Composites K1 serves: with sgd
    74 (the CPU graph of the same step; BlasOpt moves the learning rate
    of the 24 weight gradients into Dot22Scalar, which takes 24 of the 98
    Composites the step had without it); with AdamW 197 (the same count
    as without BlasOpt: no gradient is scaled by a constant there)."""
    nodes = fn.maker.fgraph.toposort()
    n_composite = len(composite_nodes(fn))
    n_grad = sum(type(n.op).__name__ == "FusedAttentionGrad" for n in nodes)
    n_attention = sum(type(n.op).__name__ == "FusedAttention" for n in nodes)
    n_scalar = sum(n.outputs[0].type.ndim == 0 for n in composite_nodes(fn))
    log(f"{label} graph: {len(nodes)} nodes, {n_composite} Composite "
        f"({len({n.op for n in composite_nodes(fn)})} distinct, {n_scalar} 0-d), "
        f"{n_attention} FusedAttention, {n_grad} FusedAttentionGrad; {blas_counts(fn)}")
    if (n_composite, n_attention, n_grad) != (n_expected, N_LAYERS, N_LAYERS):
        raise AssertionError(f"{n_composite} Composite, {n_attention} FusedAttention and {n_grad} "
                             f"FusedAttentionGrad nodes, expected {n_expected}, {N_LAYERS}, {N_LAYERS}")


def k3_occupancy():
    """Log the resources of K3's kernels from flash_bwd_kernel_info: for
    each dtype and D variant, threads, dynamic shared memory, registers,
    spill bytes, resident blocks an SM and walked rows of the dq and dK/dV
    kernels (at D <= 256 the dK and the dV passes)."""
    import ctypes
    from aesara_tpu_torch.link.torch.kernels.attention import _library

    info_fn = _library("flash_bwd").flash_bwd_kernel_info
    info_fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    info_fn.restype = ctypes.c_int
    for dtype, dtype_name in ((0, "fp32"), (1, "bf16"), (2, "fp16")):
        for dmax in (64, 128, 256):
            parts = []
            kernels = ((0, "dq"), (1, "dK"), (2, "dV")) if dmax > 128 else ((0, "dq"), (1, "dK/dV"))
            for which, kernel in kernels:
                info = (ctypes.c_int * 6)()
                err = info_fn(dtype, dmax, which, info)
                if err != 0:
                    raise RuntimeError(f"flash_bwd_kernel_info({dtype}, {dmax}, {which}) failed: {err}")
                threads, smem, regs, spill, blocks, walk = list(info)
                parts.append(f"{kernel} {threads} threads, {smem} B shared, {regs} registers, "
                             f"{spill} B spilled, {blocks} blocks ({blocks * threads // 32} warps) an SM, "
                             f"walked tiles of {walk} rows")
            log(f"K3 occupancy {dtype_name} D<={dmax}: {'; '.join(parts)}")


def k3_library_ms(q, k, v, do, scale):
    """Device ms of PyTorch's memory-efficient attention backward
    (``_scaled_dot_product_efficient_attention_backward``, fp32 on sm_90)
    on K3's inputs, viewed as (8, 16, T, D); its ``out`` and ``logsumexp``
    come from the matching forward, run outside the timed window.  None,
    with the reason logged, when the library refuses the call."""
    aten = torch.ops.aten
    fwd = aten._scaled_dot_product_efficient_attention.default
    bwd = aten._scaled_dot_product_efficient_attention_backward.default
    log(f"K3 library call: {bwd._schema}")
    q4, k4, v4, do4 = (t.reshape(8, t.shape[0] // 8, *t.shape[1:]) for t in (q, k, v, do))
    try:
        out, lse, seed, offset = call_by_schema(fwd, {
            "query": q4, "key": k4, "value": v4, "attn_bias": None, "compute_log_sumexp": True,
            "dropout_p": 0.0, "is_causal": False, "scale": scale})()
        names = {"grad_out_": do4, "grad_out": do4, "query": q4, "key": k4, "value": v4, "attn_bias": None,
                 "out": out, "logsumexp": lse, "philox_seed": seed, "philox_offset": offset,
                 "dropout_p": 0.0, "grad_input_mask": [True, True, True, False], "is_causal": False,
                 "scale": scale}
        backward = call_by_schema(bwd, names)
    except (RuntimeError, NotImplementedError, TypeError) as exc:
        log(f"K3 library call not timed: {type(exc).__name__}: {str(exc)[:200]}")
        return None
    return library_ms("K3", backward)


def phase_k3():
    """K3 against its plain version on the card: (fp32 max abs err,
    (ms, plain ms, bound ms, bound by, library ms, backward kernels ms) at
    the flagship shape, fp32, non-causal, where two calls must also give the
    same bits)."""
    from aesara_tpu_torch.link.torch.kernels.attention import (
        attention_grads_plain, flash_attention_grads,
    )

    log(f"K3 tolerances: fp32 |err| <= {K3_ATOL} + {K3_RTOL} x |plain|; "
        f"bf16 <= {BF16_REL} x max|plain|")
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(1)
    k3_occupancy()
    k3_err, k3_times = 0.0, None
    cases = [((128, 1024, 64), False, torch.float32), ((128, 1024, 64), True, torch.float32),
             ((128, 1024, 64), False, torch.bfloat16), ((128, 1024, 64), True, torch.bfloat16),
             ((6, 1000, 40), True, torch.float32), ((2, 130, 96), False, torch.float32)]
    for shape, causal, dtype in cases:
        q, k, v, do = (torch.randn(shape, device=device, generator=gen).to(dtype) for _ in range(4))
        scale = 1.0 / shape[-1] ** 0.5
        got = flash_attention_grads(q, k, v, do, causal=causal, scale=scale)
        torch.cuda.synchronize()
        want = attention_grads_plain(q, k, v, do, causal, scale)
        errs = []
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"K3 {name} {tuple(g.shape)} {g.dtype}, plain {tuple(w.shape)} {w.dtype}")
            g, w = g.float(), w.float()
            err = (g - w).abs().max().item()
            if dtype == torch.float32:
                ok = bool(((g - w).abs() <= K3_ATOL + K3_RTOL * w.abs()).all())
                k3_err = max(k3_err, err)
            else:
                ok = err <= BF16_REL * w.abs().max().item()
            if not ok:
                raise AssertionError(f"K3 {shape} causal={causal} {dtype} {name}: max err {err}")
            errs.append(err)
        split = device_split(lambda: flash_attention_grads(q, k, v, do, causal=causal, scale=scale))
        ms = sum(split.values())
        bwd = sum(t for name, t in split.items() if "flash_bwd" in name)
        rec = sum(t for name, t in split.items() if "flash_fwd" in name)
        plain_ms = device_ms(lambda: attention_grads_plain(q, k, v, do, causal, scale))
        log(f"K3 {shape} causal={causal} {str(dtype).split('.')[-1]}: max_abs_err dq/dk/dv "
            f"{errs[0]:.3e}/{errs[1]:.3e}/{errs[2]:.3e}, device ms kernel {ms:.4f} (backward "
            f"kernels {bwd:.4f}, K2 recompute {rec:.4f}, padding and cuts {ms - bwd - rec:.4f}) "
            f"plain {plain_ms:.4f}")
        if shape == (128, 1024, 64) and not causal and dtype == torch.float32:
            BH, T, D = shape
            again = flash_attention_grads(q, k, v, do, causal=causal, scale=scale)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"K3 {shape} fp32: two calls gave different bits")
            log(f"K3 {shape} fp32: two calls give the same bits for dq, dk and dv")
            # inputs q, k, v, dO and outputs dQ, dK, dV; the S, dP, dV, dQ, dK
            # products, each taken as three TF32 products on the tensor cores
            lib = k3_library_ms(q, k, v, do, scale)
            ratio = f"{bwd / lib:.3f}x the library's time" if lib else "library not timed"
            k3_bound = bound(7 * q.numel() * 4, 3 * 10 * BH * T * T * D, TF32_FLOPS)
            own_ms = 3 * 14 * BH * T * T * D / TF32_FLOPS * 1e3
            fp32_ms = 10 * BH * T * T * D / FP32_FLOPS * 1e3
            log(f"K3 {shape} fp32: backward kernels device ms {bwd:.4f} against "
                f"_scaled_dot_product_efficient_attention_backward (library) {lib}: {ratio}; "
                f"3xTF32 bound of the 5 products at {TF32_FLOPS / 1e12:.0f} TFLOP/s "
                f"{k3_bound[0]:.4f} ms (the kernels line's), of K3's 7 products {own_ms:.4f} ms; "
                f"the same 5 products in fp32 on the CUDA cores {fp32_ms:.4f} ms")
            k3_times = (ms, plain_ms, *k3_bound, lib, bwd)
    return k3_err, k3_times


def _counters():
    from aesara_tpu_torch.link.torch.kernels.attention import flash_attention, flash_attention_grads
    from aesara_tpu_torch.link.torch.kernels.elemwise import fused_elemwise

    return {"K1": fused_elemwise, "K2": flash_attention, "K3": flash_attention_grads}


def phase_train(step, params, n_composite: int = N_COMPOSITE_TRAIN, label: str = "train"):
    """3 train steps with the launch counters set to 0 just before and
    read just after; the loss must be finite and, with sgd, fall below the
    first step's at every later step.  With AdamW it is checked at the end
    of its schedule (``phase_adamw``): the first update runs at lr 0 and
    the next ones overshoot before the loss falls."""
    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    losses, times = [], []
    for _ in range(N_TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        if not (loss.is_cuda and loss.shape == () and loss.dtype == torch.float32):
            raise AssertionError(f"loss {loss} is not a float32 scalar on the card")
        # read now: a borrowed output is the captured graph's buffer, which
        # the next replay writes
        losses.append(float(loss))
    log(f"{label} step ms: {[round(t, 3) for t in times]} (the first runs eagerly and compiles, the second "
        f"captures)")
    launches = read_counters({"K1": n_composite, "K2": 2 * N_LAYERS, "K3": N_LAYERS}, label, N_TRAIN_STEPS)
    values = losses
    log(f"{label} losses: {values}")
    # sgd at lr 0.01 overshoots on this objective at full width: on the
    # CPU at batch 1 the JAX package and the port both go 3.0427 ->
    # 1.7635 -> 1.8381, so the check is that every step's loss lies
    # below the first one's
    later = values[1:] if n_composite == N_COMPOSITE_TRAIN else []
    if not all(np.isfinite(values)) or not all(v < values[0] for v in later):
        raise AssertionError(f"{label}: loss not finite or not below the first step's: {values}")
    for p in params:
        if not (p.value.is_cuda and bool(torch.isfinite(p.value).all())):
            raise AssertionError(f"parameter {p.name} not finite on the card")
    return values, launches


@functools.lru_cache(maxsize=None)
def kernel_group(name: str) -> str:
    """The group of a device kernel's time in a profiled step; every kernel
    a wrapper launches falls into its group (K6: its main pass and its
    fix-up; K7: its grouped kernel and its one-vector kernel)."""
    groups = (("flash_bwd", "K3 flash backward"), ("flash_fwd", "K2 flash forward"),
              ("softmax_group_kernel", "K4 row softmax"), ("softmax_block_kernel", "K4 row softmax"),
              ("softmax_two_pass_kernel", "K4 row softmax"),
              ("csr_spmv_kernel", "K5 CSR SpMV"), ("csr_spmm_kernel", "K6 CSR SpMM"),
              ("csr_spmm_fixup_kernel", "K6 CSR SpMM"), ("csr_sddmm", "K7 CSR SDDMM"),
              ("threefry_kernel", "TF threefry draw"), ("tg_kernel", "TG gamma"), ("tp_kernel", "TP Poisson"),
              ("tb_kernel", "TB binomial"), ("round_keys_kernel", "TP/TB round keys"), ("tm_kernel", "TM MRG31k3p"))
    for key, group in groups:
        if key in name:
            return group
    if name == "kernel":
        return "K1 fused Composite"
    if any(k in name.lower() for k in ("conv", "cudnn", "fprop", "dgrad", "wgrad", "implicit")):
        return "conv (cuDNN)"
    if "gemm" in name.lower() or "cutlass" in name.lower():
        return "matmul"
    return "other torch"


COUNTED = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "TF")


def counted_kernel(name: str):
    """The counter ("K1"-"K7", "TF") whose one launch this device kernel marks,
    or None: each wrapper call runs one such kernel (K3's dk/dv pass and
    K6's fix-up pass, second kernels of the same call, mark none; the
    forward that K3 runs again before its backward is a K2 launch, and
    K2's counter counts it)."""
    counter = kernel_group(name)[:2]
    second = "fixup" in name or "dkdv" in name
    return counter if counter in COUNTED and not second else None


def after_marker(events) -> tuple:
    """(the last marker's time range, the device events but the profiler's
    step ranges and spins that start after its start) of a trace's
    events, or (None, []) if it holds no marker: a spin shorter than
    MARKER_LIMIT_S.  Every marker runs after the lead-in call and before
    the counted ones, so any one of them that the trace kept will do."""
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    markers = [e for e in device if "spin_kernel" in e.name and e.time_range.elapsed_us() < MARKER_LIMIT_S * 1e6]
    if not markers:
        return None, []
    marker = max(markers, key=lambda e: e.time_range.start).time_range
    return marker, [e for e in device if e.time_range.start > marker.start
                    and not e.name.startswith("ProfilerStep") and "spin_kernel" not in e.name]


def profile_session(fn, label: str, steps: int = PROFILE_STEPS, gap: float = PROFILE_GAP_S):
    """``steps`` calls of ``fn`` under torch.profiler, after one call that
    the profiler traces as its warm-up and drops, with ``gap`` seconds of
    host time at each edge of the recorded window, the card spinning
    through them as in ``spin_edge``.  Inside the window one more
    call, the lead-in, runs before the counted ones and N_MARKERS short
    spin kernels, the markers, follow it on the same stream: the trace
    counts only what starts after the last marker it kept, so the records
    it loses from the first launches of a window (PERF.md §7) fall on the
    lead-in and the markers.  Returns (wall ms per call, the device events
    after that marker, the launches of K1-K7 in them and by the counters
    (the wrappers' launches plus the replay tally), the plain calls, and
    a note on where the counted kernels lie after the marker's end, in
    ms).  A trace without a marker counts no launches."""
    from torch.profiler import ProfilerActivity, profile, schedule

    for attempt in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=steps + 1, repeat=1)) as prof:
            fn()
            torch.cuda.synchronize()
            spin(gap / 2)           # before the window opens: no idle stretch in between
            prof.step()
            time.sleep(gap)
            fn()                    # the lead-in
            for _ in range(N_MARKERS):
                spin(MARKER_S)
            torch.cuda.synchronize()
            prof.step()
            zero_counters()
            t0 = time.perf_counter()
            for i in range(steps):
                fn()
                if i == steps - 1:
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3 / steps
                    spin(gap)
                    time.sleep(gap)
                prof.step()
        if device_events(prof):
            break
        log(f"profiler session {attempt + 1} saw no device activity in the {label}")
    else:
        raise RuntimeError(f"the profiler saw no device activity in the {label}")
    counters = _all_counters()
    counted = {k: counters[k].launches + counters[k].replayed for k in COUNTED}
    plain = sum(c.plain_calls for c in counters.values())
    traced = dict.fromkeys(counted, 0)
    marker, device = after_marker(prof.events())
    if marker is None:
        return wall, [], traced, counted, plain, "no marker kernel in the trace"
    for e in device:
        if counted_kernel(e.name) is not None:
            traced[counted_kernel(e.name)] += 1
    marks = sorted((e.time_range.start, counted_kernel(e.name)) for e in device if counted_kernel(e.name))
    note = f"last marker kept {marker.elapsed_us() / 1e3:.3f} ms"
    if marks:
        note += f"; first counted kernel {(marks[0][0] - marker.end) / 1e3:.3f} ms after its end"
    if 0 < len(marks) <= 24:
        note += "; counted kernels at " + " ".join(f"{k}@{(t - marker.end) / 1e3:.3f}" for t, k in marks) + " ms"
    return wall, device, traced, counted, plain, note


def profile_call(fn, label: str, steps: int = PROFILE_STEPS):
    """A ``profile_session`` of ``fn`` whose trace shows, for K1-K7, the
    launches that the counters count over the same calls: per call, the
    wall time, the device busy time and its split by kernel group and by
    kernel.  A session whose trace lost launches is logged and made again;
    raises after PROFILE_ATTEMPTS such sessions, or at once on a plain call.
    Returns (wall ms, busy ms, the trace's launches, the device events a
    call by kind)."""
    t0 = time.perf_counter()
    for attempt in range(PROFILE_ATTEMPTS):
        wall, device, traced, counted, plain, note = profile_session(fn, label, steps)
        if plain:
            raise AssertionError(f"profiled {label}: {plain} calls went to a plain version")
        if traced == counted:
            break
        log(f"profiler session {attempt + 1} of the {label} lost launches: trace {traced}, "
            f"counters {counted}; {note}")
    else:
        raise AssertionError(f"profiled {label}: in {PROFILE_ATTEMPTS} sessions the trace showed launches "
                             f"{traced}, the counters {counted}")
    groups: dict = {}
    by_name: dict = {}
    events = {"kernels": 0}     # device events a call: kernels, and copies and sets by name
    for e in device:
        kind = e.name if e.name.startswith(("Memcpy", "Memset")) else "kernels"
        events[kind] = events.get(kind, 0) + 1 / steps
        t = e.time_range.elapsed_us() / 1e3 / steps
        group = groups.setdefault(kernel_group(e.name), [0.0, 0])
        group[0] += t
        group[1] += 1
        by_name[e.name[:70]] = by_name.get(e.name[:70], 0.0) + t
    busy = sum(t for t, _ in groups.values())
    log(f"profiled {label}, {steps} calls after a dropped one and a lead-in: per call wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%)")
    for group, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"  {t:9.3f} ms  {100 * t / busy:5.1f}%  {n / steps:6.1f} kernels  {group}")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"  {t:9.3f} ms  {name}")
    log(f"  launches in {steps} calls, trace {traced}, counters {counted}; plain calls {plain}; {note}")
    log(f"  device events a call: {events}; profiled in {time.perf_counter() - t0:.2f} s")
    return wall, busy, traced, events


def time_steps(step, n: int, label: str, profile: bool = True):
    """``n`` steps back to back (host clock around work that ends in a
    synchronise), the host time of one step's call on an idle device
    (median of N_HOST_CALLS calls, each after a synchronise; where it
    comes near the step time, the host waits for the device inside the
    call), the peak device memory since the last reset and the memory the
    allocator holds (a captured graph keeps its own pool), and one profiled
    step: a dict of ms a step, host ms of one call, peak and reserved GiB,
    the profiled wall and device busy ms a call and the trace's launches
    of K1-K7 over the profiled calls, and the device events a profiled call shows (kernels,
    and copies and sets by name: a replay's graph nodes); without
    ``profile`` the last four are None (no profiled step)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / n
    peak = torch.cuda.max_memory_allocated() / 2**30
    calls = []
    for _ in range(N_HOST_CALLS):
        t0 = time.perf_counter()
        step()
        calls.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved() / 2**30
    log(f"{label}: {n} steps back to back {ms:.3f} ms each; host time of one call {statistics.median(calls):.3f} "
        f"ms (median of {N_HOST_CALLS}: {', '.join(f'{c:.3f}' for c in calls)}); peak device memory {peak:.3f} GiB, "
        f"reserved {reserved:.3f} GiB")
    wall, busy, traced, events = profile_call(step, label) if profile else (None,) * 4
    return {"ms": ms, "host": statistics.median(calls), "peak": peak, "reserved": reserved, "wall": wall,
            "busy": busy, "traced": traced, "events": events}


def time_train(step):
    """The flagship step back to back, its tokens a second, and one profiled."""
    t = time_steps(step, N_TIMED_STEPS, "full-width train step")
    log(f"full-width train step: {BATCH * SEQ / t['ms'] * 1e3:.1f} tokens/s ({BATCH}x{SEQ} tokens a step)")
    return t


def check_train_against_cpu():
    """One step at batch 1 from the same seeded weights on the card and
    on the CPU: the loss and every updated parameter agree."""
    step_gpu, params_gpu, _ = build_train_step("cuda", batch=1)
    step_cpu, params_cpu, _ = build_train_step("cpu", batch=1)
    loss_gpu, loss_cpu = step_gpu().cpu(), step_cpu()
    loss_err = abs(float(loss_gpu) - float(loss_cpu))
    param_err = 0.0
    for pg, pc in zip(params_gpu, params_cpu):
        got = pg.value.cpu()
        param_err = max(param_err, (got.double() - pc.value.double()).abs().max().item())
        torch.testing.assert_close(got, pc.value, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    torch.testing.assert_close(loss_gpu, loss_cpu, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    log(f"train step at batch 1, card vs CPU: loss {float(loss_gpu):.7f} vs {float(loss_cpu):.7f} "
        f"(abs err {loss_err:.3e}); max abs err over the {len(params_gpu)} updated parameters "
        f"{param_err:.3e} (tolerance {TRAIN_TOL})")


def compare_state(label: str, gpu, cpu, tol: float, cancel_atol=None, params=()):
    """Every state variable on the card against its CPU twin within
    ``tol`` (atol and rtol); with ``cancel_atol``, the entries of the
    ``params`` (by name) whose gradient sums cancel may differ by up to
    it, in at most ADAMW_CANCEL_SHARE of a tensor (and one entry).
    Logs the largest error of each kind."""
    worst, worst_param, n_off = 0.0, 0.0, 0
    for g, c in zip(gpu, cpu):
        if g.name != c.name or not g.value.is_cuda:
            raise AssertionError(f"{label}: state {g.name} against {c.name} on {g.value.device}")
        got, want = g.value.cpu().double(), c.value.double()
        diff = (got - want).abs()
        off = diff > tol + tol * want.abs()
        if g.name in params and cancel_atol is not None:
            worst_param = max(worst_param, diff.max().item())
            n_off += int(off.sum())
            if int(off.sum()) > max(1, ADAMW_CANCEL_SHARE * off.numel()) or diff.max().item() > cancel_atol:
                raise AssertionError(f"{label}: {g.name} {int(off.sum())} of {off.numel()} entries beyond "
                                     f"{tol}, max abs err {diff.max().item():.3e} (> {cancel_atol}?)")
        else:
            worst = max(worst, diff.max().item())
            if bool(off.any()):
                raise AssertionError(f"{label}: {g.name} max abs err {diff.max().item():.3e} beyond {tol}")
    extra = (f"; parameters max abs err {worst_param:.3e} ({n_off} entries beyond {tol}, within {cancel_atol})"
             if cancel_atol is not None else "")
    log(f"{label}, card vs CPU: {len(gpu)} state variables, max abs err {worst:.3e} (tolerance {tol}){extra}")


def adamw_cpu_reference() -> dict:
    """(d)'s CPU twin, made in ``cpu_reference``'s process: the AdamW step
    at batch 1 for N_ADAMW_CPU_STEPS steps; each step's loss, and every
    update target's name and float64 values after them."""
    t0 = time.perf_counter()
    step, params, state = build_train_step("cpu", batch=1, optimizer="adamw")
    losses = [_host(step()) for _ in range(N_ADAMW_CPU_STEPS)]
    return {"losses": losses, "state": [(v.name, v.value.double().numpy()) for v in state],
            "params": {p.name for p in params}, "seconds": time.perf_counter() - t0}


def phase_adamw(sgd_ops):
    """Path 4d: the flagship encoder trained with AdamW.  Returns K1's
    error, times and bound on the AdamW Composites, the launches of the 3
    counted steps, the step time and the peak memory."""
    t0 = time.perf_counter()
    step, params, _ = build_train_step("cuda", optimizer="adamw")
    log(f"(d) AdamW train step compile (graph + grad + rewrites + link): {time.perf_counter() - t0:.2f} s")
    check_train_graph(step, N_COMPOSITE_ADAMW, "(d) AdamW train")
    k1_err, _, k1_times, _ = phase_k1(step, np.random.default_rng(3), skip=sgd_ops,
                                      timed_shape=(D_MODEL, D_FF))
    if k1_times is None:
        raise AssertionError("no AdamW update Composite on a (d_model, d_ff) weight")
    losses, (launches, _) = phase_train(step, params, N_COMPOSITE_ADAMW, "(d) AdamW train")
    t = time_steps(step, N_TIMED_STEPS, "(d) AdamW train step")
    ms, peak = t["ms"], t["peak"]
    require_captured(step, "(d) AdamW train step")
    log(f"(d) AdamW train step: {BATCH * SEQ / ms * 1e3:.1f} tokens/s ({BATCH}x{SEQ} tokens a step)")
    # the 3 counted and 10 timed steps cover the schedule (ADAMW_TOTAL);
    # past its end lr is 0, so the parameters and the loss stay put.  On
    # the CPU at batch 1 the loss goes 3.04, 3.04 (lr 0), 9.88, 11.34, 7.46,
    # 5.62, 4.21, 2.26, ..., 0.40 at step 13: AdamW's first full-size
    # updates overshoot on this objective, then it falls
    final = float(step())
    log(f"(d) AdamW loss after the schedule's {ADAMW_TOTAL} steps and more: {final} (first step {losses[0]})")
    if not (np.isfinite(final) and final < losses[0]):
        raise AssertionError(f"(d) AdamW: loss {final} after the schedule not below the first step's {losses[0]}")
    del step, params
    release()
    t0 = time.perf_counter()
    step_gpu, _, state_gpu = build_train_step("cuda", batch=1, optimizer="adamw")
    ref = cpu_reference("adamw")
    for loss_cpu in ref["losses"]:
        torch.testing.assert_close(step_gpu().cpu(), torch.as_tensor(loss_cpu), atol=TRAIN_TOL, rtol=TRAIN_TOL)
    # the largest lr of the compared steps (the schedule at s = 0, 1); an
    # update is at most lr a step (m_hat / sqrt(v_hat) is +-1 when every
    # gradient so far is the same), and 0.1% more covers its rounding
    lr_max = ADAMW_LR * (N_ADAMW_CPU_STEPS - 1) / ADAMW_WARMUP
    state_cpu = [SimpleNamespace(name=name, value=torch.from_numpy(value)) for name, value in ref["state"]]
    compare_state(f"(d) AdamW at batch 1 after {N_ADAMW_CPU_STEPS} steps", state_gpu, state_cpu, TRAIN_TOL,
                  cancel_atol=2 * lr_max * 1.001, params=ref["params"])
    log(f"(d) card-vs-CPU check: {time.perf_counter() - t0:.2f} s")
    return {"k1_err": k1_err, "k1_times": k1_times, "launches": launches, "ms": ms, "peak": peak}


# ---------------------------------------------------------------------------
# the sparse paths: (a) bag-of-words classifier, (b) GLM, (c) values gradient
# ---------------------------------------------------------------------------

def _all_counters():
    from aesara_tpu_torch.link.torch.kernels.random_loops import binomial_draw, gamma_draw, mrg_draw, poisson_draw
    from aesara_tpu_torch.link.torch.kernels.softmax import softmax_rows
    from aesara_tpu_torch.link.torch.kernels.sparse import csr_sddmm, csr_spmm, csr_spmv
    from aesara_tpu_torch.link.torch.kernels.threefry import threefry_draw

    return {**_counters(), "K4": softmax_rows, "K5": csr_spmv, "K6": csr_spmm, "K7": csr_sddmm,
            "TF": threefry_draw, "TG": gamma_draw, "TP": poisson_draw, "TB": binomial_draw, "TM": mrg_draw}


def zero_counters():
    for c in _all_counters().values():
        c.launches = 0
        c.plain_calls = 0
        c.replayed = 0


def read_counters(per_call: dict, label: str, calls: int = 1, launching: int = None, replays: int = None):
    """The launches and the replay tally since ``zero_counters``, after
    ``calls`` calls of one captured function with a new key, each of which
    launches ``per_call`` (kernels not named there: 0): the first call
    runs eagerly, the second captures (the wrappers count the launches
    recorded into the graph) and replays, later ones replay.  Or, with
    ``launching`` and ``replays``, that many calls of each kind.  Raises
    unless both are as expected and no plain version ran; returns
    (launches, replayed) by kernel."""
    counters = _all_counters()
    launching = min(calls, 2) if launching is None else launching
    replays = max(calls - 1, 0) if replays is None else replays
    launches = {k: c.launches for k, c in counters.items()}
    replayed = {k: c.replayed for k, c in counters.items()}
    plain = sum(c.plain_calls for c in counters.values())
    expected = {k: per_call.get(k, 0) * launching for k in counters}
    expected_replayed = {k: per_call.get(k, 0) * replays for k in counters}
    log(f"{label} launches {launches} (expected {expected}), replayed {replayed} (expected {expected_replayed}); "
        f"plain calls {plain}")
    if launches != expected or replayed != expected_replayed:
        raise AssertionError(f"{label}: launch counts {launches} and replayed {replayed}, expected {expected} "
                             f"and {expected_replayed}")
    if plain != 0:
        raise AssertionError(f"{label}: {plain} calls of a plain version on the card")
    return launches, replayed


def newsgroups_like(seed: int = 300):
    """A CSR of the size of 20 Newsgroups' vectorized training split, and
    its labels, from a seed: words per document log-normal, word ids drawn
    with frequency ~ 1/rank, repeated words merged, each row scaled to unit
    L2 norm as TfidfVectorizer leaves it."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(np.rint(rng.lognormal(NG_LOG_MU, NG_LOG_SIGMA, NG_DOCS)), 1, 20000).astype(np.int64)
    total = int(lengths.sum())
    rank = np.floor(np.exp(rng.random(total) * np.log(NG_FEATURES))).astype(np.int64) - 1
    cols = rng.permutation(NG_FEATURES)[rank]
    rows = np.repeat(np.arange(NG_DOCS), lengths)
    x = sps.csr_matrix((rng.random(total).astype(np.float32), (rows, cols)), shape=(NG_DOCS, NG_FEATURES))
    norms = np.sqrt(np.add.reduceat(x.data.astype(np.float64) ** 2, x.indptr[:-1]))
    x.data /= np.repeat(norms, np.diff(x.indptr)).astype(np.float32)
    return x, rng.integers(0, NG_CLASSES, NG_DOCS).astype(np.int64)


def glm_data():
    """Config 5's data at REFRATIO_SCALE=4, as the benchmark draws x; y and
    w from a seed."""
    xs = sps.random(GLM_N, GLM_D, density=GLM_DENSITY, format="csr", dtype="float32",
                    random_state=np.random.RandomState(0))
    rng = np.random.default_rng(0)
    return xs, rng.normal(size=GLM_N).astype("float32"), (rng.normal(size=GLM_D) * 0.01).astype("float32")


def torch_csr(a):
    return torch.sparse_csr_tensor(a.indptr, a.indices, a.data, a.shape)


def matmul_bytes(a, C: int) -> int:
    """indptr, the stored entries (index + value), the rhs rows they need,
    the output."""
    n_cols = int(torch.unique(a.indices).numel())
    return (a.shape[0] + 1) * 4 + a.nnz * 8 + n_cols * C * 4 + a.shape[0] * C * 4


def sddmm_bytes(a, C: int) -> int:
    """indptr, indices, the gz rows and b rows the entries need, the output
    values."""
    n_rows = int((a.indptr[1:] > a.indptr[:-1]).sum())
    n_cols = int(torch.unique(a.indices).numel())
    return (a.shape[0] + 1) * 4 + a.nnz * 4 + (n_rows + n_cols) * C * 4 + a.nnz * 4


def check_matmul(label: str, kernel, a, b) -> dict:
    """K5 or K6 against its plain version at one shape, with the times of
    both, of torch.sparse.mm, and the bound."""
    from aesara_tpu_torch.link.torch.kernels.sparse import csr_matmul_plain

    got = kernel(a, b, torch.float32)
    torch.cuda.synchronize()
    want = csr_matmul_plain(a, b, torch.float32)
    err = (got.double() - want.double()).abs().max().item()
    torch.testing.assert_close(got, want, atol=SPARSE_TOL, rtol=SPARSE_TOL)
    C = 1 if b.dim() == 1 else b.shape[1]
    A, b2 = torch_csr(a), b.reshape(b.shape[0], -1)
    res = {"max_abs_err": err, "ms": device_ms(lambda: kernel(a, b, torch.float32)),
           "plain_ms": device_ms(lambda: csr_matmul_plain(a, b, torch.float32)),
           "library_ms": library_ms(label, lambda: torch.sparse.mm(A, b2))}
    res["bound_ms"], res["bound_by"] = bound(matmul_bytes(a, C), 2 * a.nnz * C)
    log(f"{label}: {a.shape} nnz {a.nnz} @ ({a.shape[1]}, {C}): max_abs_err {err:.3e}, device ms "
        f"kernel {res['ms']:.4f} plain {res['plain_ms']:.4f} torch.sparse.mm {res['library_ms']}; "
        f"bound {res['bound_ms']:.4f} ({res['bound_by']})")
    return res


def spmm_fresh_plan(a, b, out_dtype):
    """K6 on a copy of the CSRMat ``a`` that holds no plan, as ``predict``
    meets each request's matrix: the plan is made in the call."""
    from aesara_tpu_torch.link.torch.csr import CSRMat
    from aesara_tpu_torch.link.torch.kernels.sparse import csr_spmm

    return csr_spmm(CSRMat(a.indptr, a.indices, a.data, a.shape), b, out_dtype)


def check_sddmm(label: str, a, gz, b) -> dict:
    """K7 against its plain version at one shape (two calls with the same
    bits), with the times of both, of torch.sparse.sampled_addmm, and the
    bound."""
    from aesara_tpu_torch.link.torch.kernels.sparse import csr_sddmm, csr_sddmm_plain

    got, again = csr_sddmm(a, gz, b), csr_sddmm(a, gz, b)
    torch.cuda.synchronize()
    want = csr_sddmm_plain(a, gz, b)
    err = (got.data.double() - want.double()).abs().max().item()
    torch.testing.assert_close(got.data, want, atol=SPARSE_TOL, rtol=SPARSE_TOL)
    if got.indptr is not a.indptr or got.indices is not a.indices:
        raise AssertionError("K7 did not keep x's pattern")
    if not torch.equal(got.data, again.data):
        raise AssertionError(f"{label}: two calls of K7 gave different bits")
    C = gz.shape[1]
    A, bt = torch_csr(a), b.t().contiguous()
    res = {"max_abs_err": err, "ms": device_ms(lambda: csr_sddmm(a, gz, b)),
           "plain_ms": device_ms(lambda: csr_sddmm_plain(a, gz, b)),
           "library_ms": library_ms(label, lambda: torch.sparse.sampled_addmm(A, gz, bt, beta=0.0))}
    res["bound_ms"], res["bound_by"] = bound(sddmm_bytes(a, C), 2 * a.nnz * C)
    log(f"{label}: {a.shape} nnz {a.nnz}, gz ({a.shape[0]}, {C}), b ({a.shape[1]}, {C}): max_abs_err "
        f"{err:.3e}, device ms kernel {res['ms']:.4f} plain {res['plain_ms']:.4f} sampled_addmm "
        f"{res['library_ms']}; bound {res['bound_ms']:.4f} ({res['bound_by']})")
    return res


def check_k4(x, log_softmax: bool = True) -> dict:
    """K4 (log-softmax, or softmax) against its plain version at one
    shape, with the times of both, of torch.log_softmax (torch.softmax),
    and the bound."""
    from aesara_tpu_torch.link.torch.kernels.softmax import softmax_rows, softmax_rows_plain

    lg = log_softmax
    got = softmax_rows(x, log=lg)
    torch.cuda.synchronize()
    want = softmax_rows_plain(x, log=lg)
    err = (got.double() - want.double()).abs().max().item()
    torch.testing.assert_close(got, want, atol=SPARSE_TOL, rtol=SPARSE_TOL)
    library = torch.log_softmax if lg else torch.softmax
    res = {"max_abs_err": err, "ms": device_ms(lambda: softmax_rows(x, log=lg)),
           "plain_ms": device_ms(lambda: softmax_rows_plain(x, log=lg)),
           "library_ms": library_ms("K4", lambda: library(x, dim=-1))}
    # read and write each value once; max, subtract, exp, sum, then log and
    # subtract (log-softmax) or divide (softmax)
    res["bound_ms"], res["bound_by"] = bound(2 * x.numel() * x.element_size(), (6 if lg else 5) * x.numel())
    # the bound is HBM's: an input under the 50 MB L2 is read from L2 when
    # launched again on it, so also the time with the L2 flushed first
    flush = torch.empty(L2_FLUSH_BYTES // 4, device=x.device)
    split = device_split(lambda: (flush.zero_(), softmax_rows(x, log=lg)))
    res["cold_ms"] = sum(t for n, t in split.items() if kernel_group(n) == "K4 row softmax")
    del flush
    name = "log-softmax" if lg else "softmax"
    log(f"K4 {name} {tuple(x.shape)}: max_abs_err {err:.3e}, device ms kernel {res['ms']:.4f} (L2 flushed "
        f"before each launch {res['cold_ms']:.4f}) plain {res['plain_ms']:.4f} torch.{name.replace('-', '_')} "
        f"{res['library_ms']}; bound {res['bound_ms']:.4f} ({res['bound_by']})")
    return res


def node_names(fgraph):
    return [type(n.op).__name__ for n in fgraph.toposort()]


def check_sparse_losses(losses, label: str):
    values = list(losses)
    log(f"{label} losses: {values}")
    if not all(np.isfinite(values)) or not values[-1] < values[0]:
        raise AssertionError(f"{label}: loss not finite or not below the first step's: {values}")


def run_steps(step, n: int, label: str):
    """``n`` steps, each ending in a synchronise: the losses, read after
    each step (a borrowed loss is a captured graph's buffer)."""
    losses, times = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
    log(f"{label} step ms: {[round(t, 3) for t in times]} (the first runs eagerly, compiles and uploads; the "
        f"second captures)")
    return losses


def build_logistic(device: str, xv, yv, use_graph=None):
    """``LogisticRegression`` on a shared CSR x and shared labels: the sgd
    train step (loss on the card) and ``predict`` of a CSR argument."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch import sparse
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models.linear import LogisticRegression
    from aesara_tpu_torch.models.optim import sgd

    with config.change_flags(device=device, floatX="float32"):
        x, y = ptp.shared(xv, name="x"), ptp.shared(yv, name="y")
        model = LogisticRegression(xv.shape[1], NG_CLASSES, seed=0)
    loss = model.loss(x, y)
    mode = ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph))
    step = ptp.function([], ptp.Out(loss, borrow=True), updates=sgd(loss, model.params, lr=SPARSE_LR),
                        mode=mode)
    xin = sparse.csr_matrix("xin", dtype="float32")
    return model, step, ptp.function([xin], model.predict(xin), mode=mode)


def check_logistic_graph(fn) -> int:
    """Usmm, LogSoftmax and StructuredDot(Transpose(x), .) and no
    DenseFromSparse; returns the number of Composites (K1 launches)."""
    fgraph = fn.maker.fgraph
    nodes, names = fgraph.toposort(), node_names(fgraph)
    transposed = [n for n in nodes if type(n.op).__name__ == "StructuredDot"
                  and n.inputs[0].owner is not None and type(n.inputs[0].owner.op).__name__ == "Transpose"]
    n_composite = len(composite_nodes(fn))
    log(f"logistic regression train graph: {len(nodes)} nodes, {names.count('Usmm')} Usmm, "
        f"{names.count('LogSoftmax')} LogSoftmax, {len(transposed)} StructuredDot(Transpose(x), .), "
        f"{names.count('DenseFromSparse')} DenseFromSparse, {n_composite} Composite; {blas_counts(fn)}")
    if (names.count("Usmm"), names.count("LogSoftmax"), len(transposed), names.count("DenseFromSparse")) != (
            1, 1, 1, 0):
        raise AssertionError(f"logistic regression graph: {names}")
    return n_composite


def check_logistic_against_cpu(xv, yv):
    """One step on the first documents, full width, from the same seeded
    weights on the card and on the CPU: the loss and both parameters agree."""
    xs, ys = xv[:NG_CPU_DOCS], yv[:NG_CPU_DOCS]
    (m_gpu, step_gpu, _), (m_cpu, step_cpu, _) = build_logistic("cuda", xs, ys), build_logistic("cpu", xs, ys)
    loss_gpu, loss_cpu = step_gpu().cpu(), step_cpu()
    torch.testing.assert_close(loss_gpu, loss_cpu, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    err = 0.0
    for pg, pc in zip(m_gpu.params, m_cpu.params):
        err = max(err, (pg.value.cpu().double() - pc.value.double()).abs().max().item())
        torch.testing.assert_close(pg.value.cpu(), pc.value, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    log(f"logistic regression step at {NG_CPU_DOCS} documents, card vs CPU: loss {float(loss_gpu):.7f} vs "
        f"{float(loss_cpu):.7f}; max abs parameter err {err:.3e} (tolerance {TRAIN_TOL})")


def phase_logistic() -> dict:
    """Path (a): the bag-of-words classifier's kernels, train steps,
    serving and card-vs-CPU check."""
    from aesara_tpu_torch.link.torch.csr import CSRMat
    from aesara_tpu_torch.link.torch.kernels.sparse import csr_spmm

    t0 = time.perf_counter()
    xv, yv = newsgroups_like()
    per_row = np.diff(xv.indptr)
    log(f"(a) 20 Newsgroups-sized CSR {xv.shape}: {xv.nnz} stored entries, mean {per_row.mean():.1f} "
        f"(median {np.median(per_row):.0f}, max {per_row.max()}) a document, density "
        f"{xv.nnz / (xv.shape[0] * xv.shape[1]):.3e}; made in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    model, step, predict = build_logistic("cuda", xv, yv)
    log(f"(a) compile (graph + grad + rewrites + link): {time.perf_counter() - t0:.2f} s")
    n_composite = check_logistic_graph(step)

    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(11)
    a = CSRMat.from_scipy(xv, cuda, with_transpose=True)
    w = torch.randn((NG_FEATURES, NG_CLASSES), device=cuda, generator=gen) * 0.01
    g = torch.randn((NG_DOCS, NG_CLASSES), device=cuda, generator=gen) * 1e-3
    k6 = check_matmul("K6 forward x @ W", csr_spmm, a, w)
    k6_grad = check_matmul("K6 gradient x^T @ g (transposed twin)", csr_spmm, a.transpose(), g)
    twin = a.transpose()
    if not torch.equal(csr_spmm(twin, g), csr_spmm(twin, g)):
        raise AssertionError("K6: two calls on the transposed twin gave different bits")
    log("K6: two calls on the transposed twin give the same bits")
    req = CSRMat.from_scipy(xv[:NG_REQUEST_DOCS], cuda)
    k6_request = check_matmul(f"K6 predict request ({NG_REQUEST_DOCS} documents, plan made in the call)",
                              spmm_fresh_plan, req, w)
    log(f"K6 predict request with its plan kept: device ms {device_ms(lambda: csr_spmm(req, w)):.4f}")
    k4 = check_k4(torch.randn((NG_DOCS, NG_CLASSES), device=cuda, generator=gen) * 3)
    del a, w, g, twin, req

    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    losses = run_steps(step, N_SPARSE_STEPS, "(a) logistic regression")
    launches = read_counters({"K1": n_composite, "K4": 1, "K6": 2}, "(a) logistic regression train", N_SPARSE_STEPS)
    check_sparse_losses(losses, "(a) logistic regression")
    t = time_steps(step, N_SPARSE_TIMED, "(a) logistic regression train step")
    ms, peak, traced = t["ms"], t["peak"], t["traced"]
    require_captured(step, "(a) logistic regression train step")
    log(f"(a) logistic regression: {NG_DOCS / ms * 1e3:.1f} documents/s ({NG_DOCS} a full-batch step)")
    for p in model.params:
        if not (p.value.is_cuda and bool(torch.isfinite(p.value).all())):
            raise AssertionError(f"parameter {p.name} not finite on the card")

    requests = [xv[r * NG_REQUEST_DOCS:(r + 1) * NG_REQUEST_DOCS] for r in range(N_REQUESTS)]
    zero_counters()
    latencies, answers = [], []
    for req in requests:
        t0 = time.perf_counter()
        answers.append(predict(req))
        torch.cuda.synchronize()
        latencies.append((time.perf_counter() - t0) * 1e3)
    # each request is a new SciPy matrix, so a new key: it runs eagerly
    read_counters({"K6": 1}, "(a) predict", launching=N_REQUESTS, replays=0)
    log(f"(a) predict: {N_REQUESTS} requests of {NG_REQUEST_DOCS} documents (CSR from the host, "
        f"uploaded per request), latency ms {[round(t, 3) for t in latencies]}")
    require_captured(predict, "(a) predict on a new CSR request", captured=False)
    again = predict(requests[-1])
    if not torch.equal(again, answers[-1]):
        raise AssertionError("(a) predict: the captured request's answer differs from the eager one's")
    require_captured(predict, "(a) predict on the same CSR request again")
    profile_call(lambda: predict(requests[-1]), "(a) predict, the same request again, captured")
    require_captured(predict, "(a) predict, profiled")
    w_host, b_host = model.w.get_value(), model.b.get_value()
    for req, got in zip(requests, answers):
        want = np.argmax(req @ w_host + b_host, axis=1)
        agree = float(np.mean(got.cpu().numpy() == want))
        if got.dtype != torch.int64 or got.shape != (NG_REQUEST_DOCS,) or agree < 0.999:
            raise AssertionError(f"predict: {got.dtype} {tuple(got.shape)}, agreement with SciPy {agree}")
    log(f"(a) predict agrees with argmax(x @ W + b) by SciPy on the host for every request")
    del step, predict, model
    check_logistic_against_cpu(xv, yv)
    return {"K4": k4, "K6": k6, "K6_grad": k6_grad, "K6_request": k6_request, "launches": launches, "ms": ms,
            "traced": traced, "data": (xv, yv), "peak": peak}


#: path (b)'s optimizers: steps each takes on the card and on the CPU, and
#: whether it divides each gradient entry by a running RMS
GLM_OPTIMIZERS = {"momentum": (1, False), "rmsprop": (1, True), "adam": (1, True), "accumulate": (2, True),
                  "scaled_ema": (2, True)}


def glm_updates(recipe: str, loss, w):
    """The updates of one of path (b)'s optimizers on the GLM's w."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch.models import optim

    if recipe == "sgd":
        return {w: w - np.float32(SPARSE_LR) * ptp.grad(loss, w)}
    if recipe in ("momentum", "rmsprop", "adam"):
        return getattr(optim, recipe)(loss, [w], lr=GLM_OPT_LR)

    def adamw(grads):
        return optim.adamw_from_grads([w], grads, lr=GLM_OPT_LR)

    if recipe == "accumulate":
        return optim.accumulate_gradients(loss, [w], adamw, every=2)
    return optim.scaled_loss_updates(loss, [w], adamw) + optim.ema_updates([w], decay=0.99)[0]


def build_glm(device: str, xv, yv, wv, recipe: str = "sgd", use_graph=None):
    """The GLM step of bench_reference_ratio.py:287-296 (config 5) as the
    benchmark builds it: Monte-Carlo noise eps = RandomStream(42).normal(
    size=(d,)) * 0.01, drawn anew each step; pred = structured_dot(x, (w +
    eps)[:, None]).flatten(), mean((pred - y)^2), one update of w by sgd
    or another optimizer: (step, update targets)."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch import sparse
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.tensor import math as tm
    from aesara_tpu_torch.tensor.random.utils import RandomStream
    from aesara_tpu_torch.tensor.shape import shape_padright

    with config.change_flags(device=device, floatX="float32"):
        x, y, w = ptp.shared(xv, name="x"), ptp.shared(yv, name="y"), ptp.shared(wv, name="w")
        eps = RandomStream(seed=GLM_NOISE_SEED).normal(size=(wv.shape[0],), dtype="float32") * np.float32(GLM_NOISE)
        pred = sparse.structured_dot(x, shape_padright(w + eps)).flatten()
        loss = tm.mean(tm.sqr(pred - y))
        updates = glm_updates(recipe, loss, w)
    step = ptp.function([], ptp.Out(loss, borrow=True), updates=updates,
                        mode=ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph)))
    return step, [t for t, _ in (updates.items() if isinstance(updates, dict) else updates)]


def phase_glm_optimizers(xv, yv, wv) -> float:
    """Path (b)'s optimizers: each on the card with launch counts (K5 twice
    a step, K1 once a Composite) and K1 on its new Composites against the
    plain version, then every piece of state against the same steps on the
    CPU.  Returns K1's largest error."""
    k1_err, checked = 0.0, set()
    for recipe, (steps, normalised) in GLM_OPTIMIZERS.items():
        t0 = time.perf_counter()
        step, state = build_glm("cuda", xv, yv, wv, recipe)
        n_composite = len(composite_nodes(step))
        err, _, _, ops = phase_k1(step, np.random.default_rng(4), skip=checked, timed_shape=None)
        k1_err, checked = max(k1_err, err), checked | ops
        torch.cuda.synchronize()
        zero_counters()
        losses = [step() for _ in range(steps)]
        torch.cuda.synchronize()
        read_counters({"K1": n_composite, "K5": 2, "TF": 1}, f"(b) GLM {recipe}", steps)
        step_cpu, state_cpu = build_glm("cpu", xv, yv, wv, recipe)
        losses_cpu = [step_cpu() for _ in range(steps)]
        for got, want in zip(losses, losses_cpu):
            torch.testing.assert_close(got.cpu(), want, atol=TRAIN_TOL, rtol=TRAIN_TOL)
        # rmsprop's first step moves an entry by up to lr / sqrt(1 - rho)
        cancel = 2 * GLM_OPT_LR / np.sqrt(1 - 0.9) if normalised else None
        compare_state(f"(b) GLM {recipe}, {steps} step(s), {n_composite} Composites "
                      f"({', '.join(sorted({str(n.op.scalar_op) for n in composite_nodes(step)}))})",
                      state, state_cpu, TRAIN_TOL, cancel_atol=cancel, params={"w"})
        if steps < 2:
            step()      # the second call with the key: captured
        require_captured(step, f"(b) GLM {recipe}")
        log(f"(b) GLM {recipe}: losses {[float(v) for v in losses]}; {time.perf_counter() - t0:.2f} s")
    return k1_err


def rng_key(fn):
    """The PRNG key shared variable a compiled function reads."""
    return next(v for v in fn.fn.shared_inputs if type(v.type).__name__ == "RandomGeneratorType")


def key_after(key0, n: int) -> np.ndarray:
    """The host's key after ``n`` draws from ``key0`` (each takes the first
    key of a split), as ``jax.random`` would give it."""
    from aesara_tpu_torch.tensor.random.op import split

    key = np.asarray(key0, dtype=np.uint32)
    for _ in range(n):
        key = split(key)[0]
    return key


def check_key(var, key0, n: int, label: str):
    """A key shared variable holds the host's key after ``n`` draws from
    ``key0``, bit for bit: every call, replays included, read the key its
    storage held and wrote the next one."""
    got, want = var.get_value(), key_after(key0, n)
    log(f"{label}: key after {n} draws {got.tolist()}, the host's {want.tolist()}")
    if got.dtype != np.uint32 or not np.array_equal(got, want):
        raise AssertionError(f"{label}: key {got} after {n} draws, the host gives {want}")


def glm_key0() -> np.ndarray:
    """The first key RandomStream(seed=GLM_NOISE_SEED) makes."""
    from aesara_tpu_torch.tensor.random.op import fold_in, prng_key

    return fold_in(prng_key(GLM_NOISE_SEED), 0)


def check_glm_against_cpu(w, xv, yv, wv):
    """w after the counted steps on the card against the same steps on the
    CPU from the same seeds (the same noise: the keys are the same)."""
    step_cpu, targets_cpu = build_glm("cpu", xv, yv, wv)
    for _ in range(N_SPARSE_STEPS):
        step_cpu()
    got, want = w.get_value(), targets_cpu[0].get_value()
    diff = float(np.abs(got - want).max())
    log(f"(b) GLM: w after {N_SPARSE_STEPS} steps, card against CPU: largest difference {diff:.3e} "
        f"(tolerance {SPARSE_TOL})")
    if not np.allclose(got, want, atol=SPARSE_TOL, rtol=SPARSE_TOL):
        raise AssertionError(f"(b) GLM: w differs from the CPU's by {diff}")


def phase_glm():
    """Path (b): K5 at the GLM's shapes, the K5/K6 split, and the GLM's
    train steps.  Returns (results, the GLM's x)."""
    from aesara_tpu_torch.link.torch.csr import CSRMat
    from aesara_tpu_torch.link.torch.kernels.sparse import SPMV_MAX_C, csr_spmm, csr_spmv

    t0 = time.perf_counter()
    xv, yv, wv = glm_data()
    log(f"(b) GLM data {xv.shape}, {xv.nnz} stored entries: made in {time.perf_counter() - t0:.2f} s")
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(12)
    a = CSRMat.from_scipy(xv, cuda, with_transpose=True)
    k5 = check_matmul("K5 GLM forward x @ w[:, None]", csr_spmv, a, torch.from_numpy(wv).to(cuda)[:, None])
    k5_grad = check_matmul("K5 GLM gradient x^T @ g (transposed twin)", csr_spmv, a.transpose(),
                           torch.randn((GLM_N, 1), device=cuda, generator=gen))
    log(f"K5/K6 split at the GLM's x (device ms; csr_matmul sends widths <= {SPMV_MAX_C} to K5):")
    faster = {}
    for C in SPLIT_WIDTHS:
        b = torch.randn((GLM_D, C), device=cuda, generator=gen)
        t5, t6 = device_ms(lambda: csr_spmv(a, b)), device_ms(lambda: csr_spmm(a, b))
        faster[C] = "K5" if t5 <= t6 else "K6"
        log(f"  width {C:3d}: K5 {t5:.4f}  K6 {t6:.4f}  faster {faster[C]}")
    k5_widths = [C for C in SPLIT_WIDTHS if faster[C] == "K5"]
    log(f"K5 faster at widths {k5_widths}; SPMV_MAX_C is {SPMV_MAX_C}")
    del a

    t0 = time.perf_counter()
    step, targets = build_glm("cuda", xv, yv, wv)
    log(f"(b) compile (graph + grad + rewrites + link): {time.perf_counter() - t0:.2f} s")
    names = node_names(step.maker.fgraph)
    n_composite = len(composite_nodes(step))
    log(f"(b) GLM train graph: {len(names)} nodes, {names.count('StructuredDot')} StructuredDot, "
        f"{names.count('DenseFromSparse')} DenseFromSparse, {n_composite} Composite; {blas_counts(step)}")
    if names.count("StructuredDot") != 2 or "DenseFromSparse" in names:
        raise AssertionError(f"GLM graph: {names}")
    key, key0 = rng_key(step), glm_key0()
    if not np.array_equal(key.get_value(), key0):
        raise AssertionError("(b) GLM: the noise's key is not the stream's first key")
    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    losses = run_steps(step, N_SPARSE_STEPS, "(b) GLM")
    launches = read_counters({"K1": n_composite, "K5": 2, "TF": 1}, "(b) GLM train", N_SPARSE_STEPS)
    check_sparse_losses(losses, "(b) GLM")
    check_key(key, key0, N_SPARSE_STEPS, "(b) GLM, the counted steps")
    check_glm_against_cpu(targets[0], xv, yv, wv)
    calls = [0]

    def counted():
        calls[0] += 1
        return step()

    t = time_steps(counted, N_SPARSE_TIMED, "(b) GLM train step")
    check_key(key, key0, N_SPARSE_STEPS + calls[0], "(b) GLM, every call (a draw each, the replays' too)")
    ms, peak, traced = t["ms"], t["peak"], t["traced"]
    require_captured(step, "(b) GLM train step")
    log(f"(b) GLM: {1e3 / ms:.1f} steps/s")
    del step
    k1_err = phase_glm_optimizers(xv, yv, wv)
    return {"K5": k5, "K5_grad": k5_grad, "launches": launches, "ms": ms, "peak": peak, "k1_err": k1_err,
            "traced": traced}, (
        xv, yv, wv)


def build_values_grad(device: str, use_graph=None):
    """grad(sum(structured_dot(x, b)^2), x) for a CSR argument x."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch import sparse
    from aesara_tpu_torch.tensor import math as tm
    from aesara_tpu_torch.tensor.type import matrix

    x, b = sparse.csr_matrix("x", dtype="float32"), matrix("b", dtype="float32")
    cost = tm.sum(tm.sqr(sparse.structured_dot(x, b)))
    return ptp.function([x, b], ptp.grad(cost, x),
                        mode=ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph)))


def phase_values_grad(xv) -> dict:
    """Path (c): K7 at the GLM's size for rhs widths 1 and 20, then the
    compiled gradient on the card against the same function on the CPU."""
    from aesara_tpu_torch.link.torch.csr import CSRMat
    from aesara_tpu_torch.link.torch.kernels.sparse import SPMV_MAX_C

    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(13)
    from aesara_tpu_torch.link.torch.kernels.sparse import csr_spmm

    a = CSRMat.from_scipy(xv, cuda)
    k7 = {}
    for C in GRAD_WIDTHS:
        gz = torch.randn((GLM_N, C), device=cuda, generator=gen)
        b = torch.randn((GLM_D, C), device=cuda, generator=gen)
        k7[C] = check_sddmm(f"K7 values gradient, width {C}", a, gz, b)
    k6 = check_matmul(f"K6 values-gradient path x @ b, width {max(GRAD_WIDTHS)}", csr_spmm, a, b)
    del a
    f_gpu, f_cpu = build_values_grad("cuda"), build_values_grad("cpu")
    names = node_names(f_gpu.maker.fgraph)
    if names.count("StructuredDotGradA") != 1:
        raise AssertionError(f"values-gradient graph: {names}")
    rng = np.random.default_rng(14)
    rhs = {C: rng.normal(size=(GLM_D, C)).astype("float32") for C in GRAD_WIDTHS}
    for C in GRAD_WIDTHS:
        f_gpu(xv, rhs[C])          # one eager call a width (a key each); the next is captured
    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    outs, latencies = {}, []
    for C in GRAD_WIDTHS:
        t0 = time.perf_counter()
        outs[C] = f_gpu(xv, rhs[C])
        latencies.append((time.perf_counter() - t0) * 1e3)
        require_captured(f_gpu, f"(c) values gradient, width {C}")
    # each call is its key's second: it captures (the wrappers count the
    # launches recorded into the graph) and replays
    launches = read_counters({"K7": len(GRAD_WIDTHS), "K5": sum(C <= SPMV_MAX_C for C in GRAD_WIDTHS),
                              "K6": sum(C > SPMV_MAX_C for C in GRAD_WIDTHS)}, "(c) values gradient",
                             launching=1, replays=1)
    C = max(GRAD_WIDTHS)
    _, _, traced, _ = profile_call(lambda: f_gpu(xv, rhs[C]), f"(c) values gradient, width {C}, captured")
    require_captured(f_gpu, f"(c) values gradient, width {C}, profiled")
    log(f"(c) values gradient, widths {GRAD_WIDTHS}: call ms {[round(t, 3) for t in latencies]} "
        f"(the result goes back to SciPy); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    for C in GRAD_WIDTHS:
        got, want = outs[C], f_cpu(xv, rhs[C])
        if not (sps.isspmatrix_csr(got) and np.array_equal(got.indptr, want.indptr)
                and np.array_equal(got.indices, want.indices)):
            raise AssertionError(f"(c) width {C}: the card's result has another pattern than the CPU's")
        err = float(np.abs(got.data - want.data).max())
        np.testing.assert_allclose(got.data, want.data, atol=1e-4, rtol=SPARSE_TOL)
        log(f"(c) width {C}: card vs CPU, same pattern ({got.nnz} entries), max abs err {err:.3e}")
    return {"K7": k7[max(GRAD_WIDTHS)], "K7_err": max(r["max_abs_err"] for r in k7.values()),
            "K6": k6, "launches": launches, "traced": traced}


# ---------------------------------------------------------------------------
# path (e): the repo's reference configurations 1-3 and the MLP, dense
# ---------------------------------------------------------------------------

def build_reference(which, device: str, use_graph=None) -> dict:
    """Config 1, 2 or 3 of ``benchmarks/bench_reference_ratio.py:146-250``
    at REFRATIO_SCALE=4, built as it builds them (float32, its seed-0 data
    drawn in its order, every dataset a shared variable), or "mlp": the
    ``MLP`` with sigmoid at config 3's widths, sgd at MLP_LR, on the same
    minibatch ``givens``.  A dict: ``step`` (config 3 and the MLP take the
    minibatch index), ``loss`` (a function of the same index giving the
    loss before a step; config 2's step is its output), ``params`` (the
    trained shared variables) and ``data``."""
    import aesara_tpu_torch as ptp
    import aesara_tpu_torch.tensor as pt
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models import MLP, sgd

    mode = ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph))
    rng = np.random.default_rng(0)
    f32 = "float32"
    with config.change_flags(device=device, floatX=f32):
        if which == 1:
            X = ptp.shared(rng.normal(size=(REF_N1, REF_D1)).astype(f32), name="X")
            Y = ptp.shared((rng.random(REF_N1) > 0.5).astype(f32), name="Y")
            w = ptp.shared(rng.normal(size=REF_D1).astype(f32) * 0.01, name="w")
            b = ptp.shared(np.asarray(0.0, dtype=f32), name="b")
            p = pt.sigmoid(pt.dot(X, w) + b)
            eps = np.asarray(1e-7, dtype=f32)
            nll = -pt.mean(Y * pt.log(p + eps) + (1 - Y) * pt.log(1 - p + eps))
            gw, gb = ptp.grad(nll, [w, b])
            lr = np.asarray(REF_LR1, dtype=f32)
            step = ptp.function([], [], updates={w: w - lr * gw, b: b - lr * gb}, mode=mode)
            return dict(step=step, loss=ptp.function([], nll, mode=mode), params=[w, b], data=[X, Y])
        if which == 2:
            X = ptp.shared(rng.normal(size=(REF_N2, REF_D2)).astype(f32), name="X")
            h = X
            for _ in range(4):
                e = pt.exp(h - pt.max(h, axis=1, keepdims=True))
                sm = e / pt.sum(e, axis=1, keepdims=True)
                lse = pt.log(pt.sum(pt.exp(sm), axis=1, keepdims=True))
                h = sm * np.asarray(1.1, f32) + pt.tanh(lse)
            step = ptp.function([], pt.sum(h), mode=mode)
            return dict(step=step, loss=None, params=[], data=[X])
        x, y, idx = pt.matrix("x", dtype=f32), pt.lvector("y"), pt.iscalar("idx")
        if which == 3:
            sizes = [(REF_DIN, REF_H), (REF_H, REF_H), (REF_H, REF_DOUT)]
            ws = [ptp.shared((rng.normal(size=s) * (1.0 / np.sqrt(s[0]))).astype(f32)) for s in sizes]
            bs = [ptp.shared(np.zeros(s[1], dtype=f32)) for s in sizes]
            h = x
            for i, (wi, bi) in enumerate(zip(ws, bs)):
                h = pt.dot(h, wi) + bi
                if i < 2:
                    h = pt.tanh(h)
            lse = pt.log(pt.sum(pt.exp(h - pt.max(h, axis=1, keepdims=True)), axis=1)) + pt.max(h, axis=1)
            loss = pt.mean(lse - h[pt.arange(y.shape[0]), y])
            params = ws + bs
            grads = ptp.grad(loss, params)
            lr = np.asarray(REF_LR3, f32)
            updates = {p: p - lr * g for p, g in zip(params, grads)}
        else:
            model = MLP(REF_DIN, [REF_H, REF_H], REF_DOUT, activation="sigmoid", seed=0)
            loss, params = model.loss(x, y), model.params
            updates = sgd(loss, params, lr=MLP_LR)
        Xd = ptp.shared(rng.normal(size=(REF_NBATCH * REF_B, REF_DIN)).astype(f32), name="Xd")
        Yd = ptp.shared(rng.integers(0, REF_DOUT, size=REF_NBATCH * REF_B).astype("int64"), name="Yd")
    B = REF_B
    givens = {x: Xd[idx * B:(idx + 1) * B], y: Yd[idx * B:(idx + 1) * B]}
    step = ptp.function([idx], [] if which == 3 else ptp.Out(loss, borrow=True), updates=updates,
                        givens=givens, mode=mode)
    built = dict(step=step, loss=ptp.function([idx], loss, givens=givens, mode=mode), params=params,
                 data=[Xd, Yd])
    if which == "mlp":
        built["predict"] = ptp.function([idx], model.predict(x), givens={x: givens[x]}, mode=mode)
        built["model"] = model
    return built


def reference_call(built, which):
    """A callable driving ``built``'s step through the minibatches in turn
    (configs 1 and 2 take no index)."""
    if which in (1, 2):
        return built["step"]
    state = {"i": 0}

    def call():
        out = built["step"](np.int32(state["i"] % REF_NBATCH))
        state["i"] += 1
        return out

    return call


def check_composites(nodes, label: str, rng, full=(REF_B, REF_H), shapes=None, time_each: bool = True) -> list:
    """K1 on each distinct Composite among ``nodes`` (those a function runs
    on the card) against its plain version (F32_ATOL; a bfloat16 or float16
    output BF16_REL of its scale), on values in (0.05, 0.95)
    (every log, division and sigmoid of paths (e) and (f) stays finite
    there) at the shapes the path gives it: those a run gave its inputs
    where ``shapes`` ({node: input shapes}, ``composite_shapes``) has them,
    else with an unknown dim ``full``'s.  Each is timed, or with
    ``time_each`` False only the one that moves the most bytes, with None
    none: per Composite a dict with its error, and its times and bound
    (None where not timed)."""
    from aesara_tpu_torch.link.torch.kernels.elemwise import ElemwiseKernel, composite_plain, fused_elemwise

    device = torch.device("cuda")
    rows, seen, largest = [], set(), None
    for node in nodes:
        if node.op in seen:
            continue
        seen.add(node.op)
        comp = node.op.scalar_op
        out_dtype = node.outputs[0].type.dtype
        kernel = ElemwiseKernel(comp, [v.type.dtype for v in node.inputs], out_dtype)
        args = composite_inputs(node, rng, device, full=full, sample="unit",
                                shapes=None if shapes is None else shapes[node])
        got = fused_elemwise(kernel, *args)
        torch.cuda.synchronize()
        want = composite_plain(comp, out_dtype, *args)
        err = (got.double() - want.double()).abs().max().item() if got.numel() else 0.0
        # a Composite rounding to 16 bits within its type's share of its scale (phase_k1's gate)
        rel = k1_rel_gate(comp, out_dtype)
        tol = F32_ATOL if rel is None else rel * want.double().abs().max().item()
        if not err <= tol or got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{label} K1 {comp} {tuple(got.shape)} {got.dtype}: max err {err} > {tol}")
        n_bytes = sum(a.numel() * a.element_size() for a in args) + got.numel() * got.element_size()
        ops = ".".join(sorted(type(n.op).__name__ for n in comp.nodes))
        ins = [f"{tuple(a.shape)} {str(a.dtype).split('.')[-1]}" for a in args]
        row = dict(ops=ops, shape=tuple(got.shape), max_abs_err=err, ms=None, plain_ms=None, bound_ms=None,
                   bound_by=None)
        rows.append(row)
        entry = (n_bytes, row, kernel, comp, out_dtype, args, got.numel())
        line = f"{label} K1 {{{ops}}} inputs [{', '.join(ins)}] -> {tuple(got.shape)} {out_dtype}"
        if time_each:
            log(f"{line}: max_abs_err {err:.3e}, {time_composite(*entry)}")
            continue
        log(f"{line}: max_abs_err {err:.3e}")
        if largest is None or n_bytes > largest[0][0]:
            largest = (entry, line)
    if largest is not None and time_each is not None:
        entry, line = largest
        log(f"{line}, the one that moves the most bytes: {time_composite(*entry)}")
    return rows


def time_composite(n_bytes, row, kernel, comp, out_dtype, args, n_out) -> str:
    """Fill a ``check_composites`` row's device ms of K1 and its plain
    version, and its bound; returns them as text for the log."""
    row["ms"], row["plain_ms"] = k1_and_plain_ms(kernel, comp, out_dtype, args)
    row["bound_ms"], row["bound_by"] = bound(n_bytes, n_out * len(comp.nodes))
    return (f"device ms kernel {row['ms']:.4f} plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
            f"({row['bound_by']})")


def reference_graph(fn, label: str) -> dict:
    """The kernels one call of ``fn`` launches (K1: its Composites on the
    card; K4: its softmax nodes), logged with the graph's ops."""
    names = node_names(fn.maker.fgraph)
    per_call = {"K1": len(composite_nodes(fn)),
                "K4": sum(n in ("Softmax", "LogSoftmax") for n in names)}
    counts = {n: names.count(n) for n in sorted(set(names))}
    log(f"{label} graph: {len(names)} nodes {counts}; launches a call {per_call}")
    return per_call


def set_params(params, values):
    for p, v in zip(params, values):
        p.set_value(v)


def check_minibatches(built, which, label: str):
    """Each minibatch's step, replayed from a captured graph, against an
    eager run (``use_graph=False``) of the same step from the same weights:
    every parameter and the loss after it, bitwise or within CAPTURE_REL
    of each tensor's scale.  The start of the minibatch is computed on the
    card from the index, so each replay must read its own."""
    eager = build_reference(which, "cuda", use_graph=False)
    start = [p.get_value() for p in eager["params"]]
    step, worst = built["step"], 0.0
    for i in range(REF_NBATCH):
        for b in (built, eager):
            set_params(b["params"], start)
            b["step"](np.int32(i))
        if not step.captured:
            raise AssertionError(f"{label}: minibatch {i} did not replay the captured graph")
        got = [p.get_value() for p in built["params"]] + [_host(built["loss"](np.int32(i)))]
        want = [p.get_value() for p in eager["params"]] + [_host(eager["loss"](np.int32(i)))]
        diff, rel, same = _difference(got, want)
        if not same and rel > CAPTURE_REL:
            raise AssertionError(f"{label}: minibatch {i} captured and eager differ by {rel:.3e} of a tensor's "
                                 "scale")
        worst = max(worst, rel)
    log(f"{label}: each of the {REF_NBATCH} minibatches, replayed, equals its eager step (parameters and "
        f"loss; largest difference {worst:.3e} of a tensor's scale)")
    del eager
    release()


def check_reference_against_cpu(built, which, label: str):
    """One step (minibatch 0) from the same weights on the card and on the
    CPU: the loss (config 2: the output) and every parameter, TRAIN_TOL."""
    cpu = build_reference(which, "cpu")
    set_params(built["params"], [p.get_value() for p in cpu["params"]])
    index = () if which in (1, 2) else (np.int32(0),)
    if which == 2:
        got, want = [_host(built["step"]())], [_host(cpu["step"]())]
    else:
        got, want = [_host(built["loss"](*index))], [_host(cpu["loss"](*index))]
        built["step"](*index)
        cpu["step"](*index)
        got += [p.get_value() for p in built["params"]]
        want += [p.get_value() for p in cpu["params"]]
    err = 0.0
    for g, w in zip(got, want):
        err = max(err, float(np.abs(np.asarray(g, "float64") - np.asarray(w, "float64")).max()))
        np.testing.assert_allclose(g, w, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    what = "the output" if which == 2 else f"loss and {len(got) - 1} parameters"
    log(f"{label}: one step card vs CPU at full width, {what}: max abs err {err:.3e} (tolerance {TRAIN_TOL}, "
        f"relative and absolute)")


def run_reference(which, label: str) -> dict:
    """One configuration of path (e): graph and K1/K4 checks, 3 counted
    steps, 10 timed and 3 profiled, the loss, capture, each minibatch
    against its eager step, and the card against the CPU."""
    t0 = time.perf_counter()
    built = build_reference(which, "cuda")
    step, loss = built["step"], built["loss"]
    log(f"{label}: compile (graph + grad + rewrites + link): {time.perf_counter() - t0:.2f} s")
    per_call = reference_graph(step, label)
    rows = check_composites(composite_nodes(step), label, np.random.default_rng(31))
    index = () if which in (1, 2) else (np.int32(0),)
    loss_before = float(_host(loss(*index))) if loss is not None else None
    call = reference_call(built, which)
    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    outs = [_host(call()) for _ in range(N_REF_STEPS)]
    launches = read_counters(per_call, label, N_REF_STEPS)
    t = time_steps(call, N_REF_TIMED, label)
    require_captured(step, label)
    if step.capture_blocker is not None:
        raise AssertionError(f"{label}: capture blocked by {step.capture_blocker}")
    if which == 2:
        if not all(np.isfinite(o) and o == outs[0] for o in outs):
            raise AssertionError(f"{label}: outputs {outs} not finite or not the same each call")
        log(f"{label}: output {float(outs[0])} each call")
    elif which == 1:
        after = float(_host(loss()))
        log(f"{label}: loss {loss_before:.6f} before the {N_REF_STEPS + N_REF_TIMED} steps and more, "
            f"{after:.6f} after")
        if not (np.isfinite(after) and after < loss_before):
            raise AssertionError(f"{label}: the loss did not fall: {loss_before} -> {after}")
    else:
        # the loss of one minibatch before and after a step on it
        first = float(_host(loss(np.int32(0))))
        step(np.int32(0))
        second = float(_host(loss(np.int32(0))))
        log(f"{label}: minibatch 0 loss {loss_before:.6f} before any step, {first:.6f} after the run, "
            f"{second:.6f} after one more step on it")
        if not (np.isfinite(second) and second < first):
            raise AssertionError(f"{label}: a step on minibatch 0 did not lower its loss: {first} -> {second}")
    if which == "mlp":
        check_predict(built, label)
    if which in (3, "mlp"):
        check_minibatches(built, which, label)
    check_reference_against_cpu(built, which, label)
    k4 = None
    if which == 2:
        k4 = check_k4(torch.randn((REF_N2, REF_D2), device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(21)) * 3, log_softmax=False)
    elif which == "mlp":
        k4 = check_k4(torch.randn((REF_B, REF_DOUT), device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(22)) * 3)
    busy = (f"{t['busy']:.3f} of {t['wall']:.3f} ms ({100 * t['busy'] / t['wall']:.1f}%)"
            if t["busy"] is not None else "not measured")
    log(f"{label}: {t['ms']:.3f} ms a step back to back, host {t['host']:.3f} ms a call, device busy {busy}, "
        f"peak {t['peak']:.3f} GiB")
    del built, step, loss, call
    release()
    return dict(t, launches=launches, composites=rows, k4=k4)


def check_predict(built, label: str):
    """``predict`` of minibatch 0 against argmax of the logits computed on
    the host from the card's weights."""
    got = built["predict"](np.int32(0))
    xs = built["data"][0].get_value()[:REF_B].astype("float64")
    h = xs
    ws = [p.get_value().astype("float64") for p in built["params"]]
    for i in range(0, len(ws), 2):
        h = h @ ws[i] + ws[i + 1]
        if i < len(ws) - 2:
            h = 1.0 / (1.0 + np.exp(-h))
    agree = float(np.mean(got.cpu().numpy() == np.argmax(h, axis=1)))
    if got.dtype != torch.int64 or tuple(got.shape) != (REF_B,) or agree < 0.99:
        raise AssertionError(f"{label} predict: {got.dtype} {tuple(got.shape)}, agreement with the host {agree}")
    log(f"{label}: predict of minibatch 0 agrees with argmax of the host's logits on {agree:.4f} of the rows")


def reference_only():
    """--reference: the setup and path (e) alone."""
    phase_setup()
    phase_reference()
    log("chip_smoke --reference: path (e) passed")


def phase_reference() -> dict:
    """Path (e): configs 1-3 and the MLP (see the module docstring)."""
    t0 = time.perf_counter()
    out = {}
    for which, label in ((1, "(e) config 1 logistic regression"), (2, "(e) config 2 softmax chain"),
                         (3, "(e) config 3 MNIST MLP"), ("mlp", "(e) MLP model (sigmoid)")):
        out[which] = run_reference(which, label)
    log(f"(e) reference configs: {time.perf_counter() - t0:.2f} s")
    return out


# ---------------------------------------------------------------------------
# path (f): Scan, config 4 (Elman RNN by BPTT) and the LSTM
# ---------------------------------------------------------------------------

def build_scan_path(which, device: str, use_graph=None) -> dict:
    """Config 4 of ``benchmarks/bench_reference_ratio.py:247-276`` at
    REFRATIO_SCALE=4 ("config4"), built as it builds it (float32, x, Wx, Wh
    and b shared, drawn from its seed 0 in its order, sgd at SCAN_LR), its
    loss returned by each step; or "lstm": ``LSTM(SCAN_DIN, SCAN_H,
    LSTM_NOUT)`` from seed 0 trained with ``adam(lr=LSTM_LR)`` on an input
    X (SCAN_T, SCAN_B, SCAN_DIN) and int32 labels from seed 5, with
    ``predict``.  A dict: ``step``, ``call`` (one step), ``loss`` (a
    function giving the loss before a step), ``params``."""
    import aesara_tpu_torch as ptp
    import aesara_tpu_torch.tensor as pt
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models import LSTM, adam
    from aesara_tpu_torch.scan import scan

    mode = ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph))
    f32 = "float32"
    with config.change_flags(device=device, floatX=f32):
        if which == "config4":
            rng = np.random.default_rng(0)
            x = ptp.shared(rng.normal(size=(SCAN_T, SCAN_B, SCAN_DIN)).astype(f32), name="x")
            wx = ptp.shared((rng.normal(size=(SCAN_DIN, SCAN_H)) * 0.1).astype(f32))
            wh = ptp.shared((rng.normal(size=(SCAN_H, SCAN_H)) * 0.1).astype(f32))
            bh = ptp.shared(np.zeros(SCAN_H, dtype=f32))
            h0 = pt.zeros((SCAN_B, SCAN_H), dtype=f32)
            hs, _ = scan(lambda xt, htm1: pt.tanh(pt.dot(xt, wx) + pt.dot(htm1, wh) + bh), sequences=[x],
                         outputs_info=[h0])
            loss = pt.mean(hs[-1] ** 2) + pt.mean(hs ** 2)
            params = [wx, wh, bh]
            grads = ptp.grad(loss, params)
            lr = np.asarray(SCAN_LR, f32)
            step = ptp.function([], ptp.Out(loss, borrow=True),
                                updates={p: p - lr * g for p, g in zip(params, grads)}, mode=mode)
            return dict(step=step, call=step, loss=ptp.function([], loss, mode=mode), params=params)
        model = LSTM(SCAN_DIN, SCAN_H, LSTM_NOUT, seed=0)
        X, y = pt.tensor3("X", dtype=f32), pt.ivector("y")
        loss = model.loss(X, y)
        step = ptp.function([X, y], ptp.Out(loss, borrow=True), updates=adam(loss, model.params, lr=LSTM_LR),
                            mode=mode)
        rng = np.random.default_rng(5)
        xv = rng.normal(size=(SCAN_T, SCAN_B, SCAN_DIN)).astype(f32)
        yv = rng.integers(0, LSTM_NOUT, size=SCAN_B).astype("int32")
        loss_fn = ptp.function([X, y], loss, mode=mode)
        return dict(step=step, call=lambda: step(xv, yv), loss=lambda: loss_fn(xv, yv),
                    params=model.params, model=model, data=(xv, yv),
                    predict=ptp.function([X], model.predict(X), mode=mode),
                    logits=ptp.function([X], model.logits(X), mode=mode))


def scan_op_counts(fn) -> list:
    """[{op: count} of the compiled graph, then (info, {op: count}) of each
    Scan's own inner graph], a Composite named by its sorted scalar ops,
    an Elemwise by its scalar op (as the JAX-side counts were taken)."""
    from collections import Counter

    def name(node):
        scalar = getattr(node.op, "scalar_op", None)
        if scalar is None:
            return type(node.op).__name__
        if type(scalar).__name__ == "Composite":
            return "Composite{" + ".".join(sorted(type(n.op).__name__ for n in scalar.nodes)) + "}"
        return f"Elemwise{{{type(scalar).__name__}}}"

    order = fn.maker.fgraph.toposort()
    out = [dict(Counter(name(n) for n in order))]
    out += [(str(n.op.info), dict(Counter(name(m) for m in n.op.fgraph.toposort())))
            for n in order if type(n.op).__name__ == "Scan"]
    return out


def scan_launches(fn, steps: int = SCAN_T) -> tuple:
    """(K1, K4 and threefry launches one call of ``fn`` makes, its Composite
    nodes on the card): its own, and each Scan's inner program's times its
    trip count (every Scan of ``fn`` runs ``steps`` steps)."""
    from aesara_tpu_torch.scalar.composite import Composite
    from aesara_tpu_torch.tensor.random.op import RandomVariable

    counts, nodes = {"K1": 0, "K4": 0, "TF": 0}, []

    def walk(program, times):
        for node, fn_, fold in zip(program.order, program.fns, program.folds):
            if fold:
                continue
            if isinstance(getattr(node.op, "scalar_op", None), Composite):
                counts["K1"] += times
                nodes.append(node)
            elif type(node.op).__name__ in ("Softmax", "LogSoftmax"):
                counts["K4"] += times
            elif isinstance(node.op, RandomVariable):
                counts["TF"] += times
            elif type(node.op).__name__ == "Scan":
                walk(fn_.program, times * steps)

    walk(fn.fn.program, 1)
    return counts, nodes


def check_scan_against_cpu(built, which, label: str):
    """One step from the same state (every update target: the weights and
    the optimizer's moments and step) on the card and on the CPU at full
    width: the loss and every parameter, TRAIN_TOL."""
    cpu = build_scan_path(which, "cpu")
    set_params(built["step"].update_targets, [v.get_value() for v in cpu["step"].update_targets])
    got, want = [_host(built["loss"]())], [_host(cpu["loss"]())]
    built["call"]()
    cpu["call"]()
    got += [p.get_value() for p in built["params"]]
    want += [p.get_value() for p in cpu["params"]]
    err = 0.0
    for g, w in zip(got, want):
        err = max(err, float(np.abs(np.asarray(g, "float64") - np.asarray(w, "float64")).max()))
        np.testing.assert_allclose(g, w, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    log(f"{label}: one step card vs CPU at full width, loss and {len(got) - 1} parameters: max abs err "
        f"{err:.3e} (tolerance {TRAIN_TOL}, relative and absolute)")


def check_lstm_predict(built, label: str):
    """3 ``predict`` requests of new sequences: each the argmax of the
    logits computed on the host from the card's weights, the last replayed."""
    ws = {p.name: p.get_value().astype("float64") for p in built["params"]}
    H = SCAN_H
    for r in range(N_SCAN_REQUESTS):
        xv = np.random.default_rng(200 + r).normal(size=(SCAN_T, SCAN_B, SCAN_DIN)).astype("float32")
        got = built["predict"](xv).cpu().numpy()
        h = c = np.zeros((SCAN_B, H))
        for t in range(SCAN_T):
            g = np.concatenate([xv[t].astype("float64"), h], axis=1) @ ws["w_lstm"] + ws["b_lstm"]
            sig = lambda v: 1.0 / (1.0 + np.exp(-v))  # noqa: E731
            c = sig(g[:, H:2 * H]) * c + sig(g[:, :H]) * np.tanh(g[:, 2 * H:3 * H])
            h = sig(g[:, 3 * H:]) * np.tanh(c)
        agree = float(np.mean(got == np.argmax(h @ ws["w_out"] + ws["b_out"], axis=1)))
        if agree < 0.99:
            raise AssertionError(f"{label} predict request {r}: agreement with the host {agree}")
        log(f"{label}: predict request {r} agrees with argmax of the host's logits on {agree:.4f} of the rows")
    require_captured(built["predict"], f"{label} predict")


def run_scan_path(which, label: str) -> dict:
    """One model of path (f): the op counts against the JAX package's,
    K1 on every Composite (inner ones too), 3 counted steps, 10 timed and
    3 profiled, capture, the loss, the card against the CPU (and the
    LSTM's predict and K4)."""
    t0 = time.perf_counter()
    built = build_scan_path(which, "cuda")
    step = built["step"]
    log(f"{label}: compile (graph + grad + rewrites + link): {time.perf_counter() - t0:.2f} s")
    counts = scan_op_counts(step)
    want = SCAN_JAX_COUNTS[which]
    log(f"{label} FAST_RUN op counts, outer then each Scan's inner graph: {counts}")
    if counts != want:
        raise AssertionError(f"{label}: op counts {counts} differ from the JAX package's {want}")
    per_call, nodes = scan_launches(step)
    log(f"{label}: launches a call {per_call} ({len(nodes)} Composite nodes, inner ones counted once)")
    rows = check_composites(nodes, label, np.random.default_rng(41), full=(SCAN_T, SCAN_B, SCAN_H))
    loss_before = float(_host(built["loss"]()))
    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    losses = [float(_host(built["call"]())) for _ in range(N_SCAN_STEPS)]
    launches = read_counters(per_call, label, N_SCAN_STEPS)
    t = time_steps(built["call"], N_SCAN_TIMED, label)
    require_captured(step, label)
    if step.capture_blocker is not None:
        raise AssertionError(f"{label}: capture blocked by {step.capture_blocker}")
    after = float(_host(built["loss"]()))
    log(f"{label}: loss {loss_before:.6f} before the steps, {losses} over the counted ones, {after:.6f} after "
        f"{N_SCAN_STEPS + N_SCAN_TIMED} steps and more")
    if not (np.isfinite(after) and after < loss_before):
        raise AssertionError(f"{label}: the loss did not fall: {loss_before} -> {after}")
    k4 = None
    if which == "lstm":
        check_lstm_predict(built, label)
        k4 = check_k4(torch.randn((SCAN_B, LSTM_NOUT), device="cuda",
                                  generator=torch.Generator(device="cuda").manual_seed(23)) * 3)
    check_scan_against_cpu(built, which, label)
    busy = (f"{t['busy']:.3f} of {t['wall']:.3f} ms ({100 * t['busy'] / t['wall']:.1f}%)"
            if t["busy"] is not None else "not measured")
    log(f"{label}: {t['ms']:.3f} ms a step back to back ({SCAN_T * SCAN_B / t['ms'] * 1e3:.1f} sequence steps "
        f"x batch rows a second), host {t['host']:.3f} ms a call, device busy {busy}, peak {t['peak']:.3f} GiB")
    del built, step
    release()
    return dict(t, launches=launches, composites=rows, k4=k4)


def scan_only():
    """--scan: the setup and path (f) alone."""
    phase_setup()
    phase_scan()
    log("chip_smoke --scan: path (f) passed")


def phase_scan() -> dict:
    """Path (f): config 4 and the LSTM (see the module docstring)."""
    t0 = time.perf_counter()
    out = {which: run_scan_path(which, label) for which, label in (
        ("config4", "(f) config 4 Elman RNN by BPTT"), ("lstm", "(f) LSTM with adam"))}
    log(f"(f) scan paths: {time.perf_counter() - t0:.2f} s")
    return out


# ---------------------------------------------------------------------------
# path (g): serve the decoder LM (models/decoder.py, quant.py, serve.py)
# ---------------------------------------------------------------------------

def build_decoder(device: str, vocab: int = DEC_VOCAB, floatX: str = "float32"):
    """``DecoderLM(vocab, 4, 512, 8, 2048, seed=0)`` in ``floatX`` on
    ``device`` (``benchmarks/bench_decode.py:20-27``; ``bench_serving.py:22``
    with vocab 2048)."""
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models.decoder import DecoderLM

    with config.change_flags(device=device, floatX=floatX):
        return DecoderLM(vocab, DEC_LAYERS, DEC_D, DEC_HEADS, DEC_FF, seed=0)


def decoder_mode(use_graph=None, device: str = "cuda"):
    import aesara_tpu_torch as ptp

    return ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph))


def last_logits_fn(lm):
    """``tokens -> logits after the last one`` by the full-sequence forward
    (``full()``) of a CPU model: the tie rule's oracle."""
    import aesara_tpu_torch as ptp
    import aesara_tpu_torch.tensor as pt

    toks = pt.lvector("toks")
    h = lm.embed[toks]
    for layer in lm.layers:
        h = layer.full(h)
    return ptp.function([toks], pt.dot(h[-1], lm.embed.T), mode=decoder_mode(device="cpu"))


def tie_rule(label: str, got, want, prefix, oracle, rel: float = TIE_REL) -> int:
    """Hold the card's tokens ``got`` to ``want``: equal, or equal up to a
    first difference at a step where the oracle's top-2 logit gap (after
    ``prefix`` and ``want``'s tokens before it) is under ``rel`` (TIE_REL
    unless given) of the logits' scale, where the comparison stops.
    Returns the tokens that agree."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    if got == want:
        return len(got)
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    logits = _host(oracle(np.asarray(list(prefix) + want[:k], dtype="int64"))).astype("float64")
    top = np.sort(logits)[-2:]
    gap, scale = float(top[1] - top[0]), float(np.abs(logits).max())
    log(f"{label}: first difference at token {k} ({got[k]} against {want[k]}); the CPU's top-2 logit gap there "
        f"{gap:.3e}, {gap / scale:.3e} of the logits' scale (tie rule: under {rel})")
    if not gap < rel * scale:
        raise AssertionError(f"{label}: token {k} differs ({got[k]} against {want[k]}) where the top-2 logit gap "
                             f"{gap:.3e} is not a tie")
    return k


def large_copies(call, shape) -> tuple:
    """(copies of a ``shape`` tensor one call makes, and the shapes of every
    copy of 1 MiB or more): the ``aten::copy_`` ops (a clone or a dtype
    conversion is one), in the op trace of one eager call of ``call`` (an
    eager call runs the lowerings that a capture records)."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        call()
        torch.cuda.synchronize()
    sizes = []
    for e in prof.events():
        if e.name == "aten::copy_" and e.input_shapes and e.input_shapes[0]:
            if 4 * int(np.prod(e.input_shapes[0])) >= 1 << 20:
                sizes.append(tuple(e.input_shapes[0]))
    return sum(s == tuple(shape) for s in sizes), sizes


def decoder_composites(fn, full) -> list:
    """The Composite nodes a call of ``fn`` runs on the card, the Scan's
    inner program's among them, with the ``full`` shape of their unknown
    dims."""
    from aesara_tpu_torch.scalar.composite import Composite

    nodes = []

    def walk(program):
        for node, fn_, fold in zip(program.order, program.fns, program.folds):
            if fold:
                continue
            if isinstance(getattr(node.op, "scalar_op", None), Composite):
                nodes.append(node)
            elif type(node.op).__name__ == "Scan":
                walk(fn_.program)

    walk(fn.fn.program)
    return [(n, full) for n in nodes]


def run_decoder_fn(fn, call, label: str, steps: int, tokens_per_call: int, unit: str = "tokens",
                   sampled: bool = False, n_timed: int = N_DEC_TIMED, profile: bool = True) -> dict:
    """3 counted calls (eager, capture, replay, timed each), ``n_timed``
    timed back to back and (with ``profile``) 3 profiled of one decoder
    function: its launches, tokens/s, host time, busy share, kernels a
    call, peak and reserved memory.  The calls give the same tokens, or with
    ``sampled`` each call other tokens than the one before (the key
    advances every call)."""
    start = time.perf_counter()
    per_call, nodes = scan_launches(fn, steps=steps)
    log(f"{label}: launches a call {per_call} ({len(nodes)} Composite nodes, inner ones counted once; "
        f"{len(fn.maker.fgraph.apply_nodes)} outer graph nodes)")
    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    outs, secs = [], []
    for _ in range(N_DEC_CALLS):
        t0 = time.perf_counter()
        outs.append(_host(call()))
        secs.append(time.perf_counter() - t0)
    launches = read_counters(per_call, label, N_DEC_CALLS)
    require_captured(fn, label)
    if fn.capture_blocker is not None:
        raise AssertionError(f"{label}: capture blocked by {fn.capture_blocker}")
    def same(a, b):
        return all(np.array_equal(x, y) for x, y in zip(a, b)) if isinstance(a, list) else np.array_equal(a, b)

    for prev, o in zip(outs, outs[1:]):
        if sampled == same(o, prev if sampled else outs[0]):
            raise AssertionError(f"{label}: a call gave the tokens of the one before" if sampled
                                 else f"{label}: a replay gave other tokens than the eager call")
    t = time_steps(call, n_timed, label, profile=profile)
    rate = tokens_per_call / t["ms"] * 1e3
    busy = (f"{t['busy']:.3f} of {t['wall']:.3f} ms ({100 * t['busy'] / t['wall']:.1f}%)"
            if profile else "not profiled")
    log(f"{label}: eager call {secs[0]:.3f} s, capture call (capture + first replay) {secs[1]:.3f} s, replay "
        f"{secs[2] * 1e3:.3f} ms; {t['ms']:.3f} ms a call back to back = {rate:.1f} {unit}/s; host "
        f"{t['host']:.3f} ms a call; device busy {busy}; a replay's device events {t['events']}; peak "
        f"{t['peak']:.3f} GiB, reserved {t['reserved']:.3f} GiB; {time.perf_counter() - start:.1f} s in all")
    return dict(t, launches=launches, rate=rate, out=outs[0], outs=outs, eager_s=secs[0],
                capture_s=secs[1] - secs[2])


def run_batcher(srv, chunk: int, prompts, label: str, oracle, reference) -> dict:
    """(g5) at one chunk: 32 requests drained once (the first calls of each
    function run eagerly and capture), then 32 more of the same prompts
    drained with the counters set to 0 (every call replays): tokens/s of
    that drain, each request's tokens against ``reference`` under the tie
    rule, and ``_decode`` timed and profiled."""

    def drain():
        rids = [srv.submit(p, max_new=SERVE_NEW) for p in prompts]
        steps = 0
        while srv.pending():
            srv.step()
            steps += 1
        return [srv.result(r) for r in rids], steps

    pre, _ = scan_launches(srv._prefill, steps=1)
    dec, _ = scan_launches(srv._decode, steps=chunk)
    t0 = time.perf_counter()
    first, _ = drain()
    log(f"{label}: first drain (eager and capture calls) {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    t0 = time.perf_counter()
    results, steps = drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_tok = sum(len(r) for r in results)
    counters = _all_counters()
    expected = {k: pre.get(k, 0) * len(prompts) + dec.get(k, 0) * steps for k in ("K1", "K4")}
    replayed = {k: counters[k].replayed for k in ("K1", "K4")}
    launched = {k: counters[k].launches for k in COUNTED}
    log(f"{label}: second drain {n_tok} tokens of {len(prompts)} requests ({steps} decode calls) in {wall:.3f} s = "
        f"{n_tok / wall:.1f} tokens/s; replayed {replayed} (expected {expected}), launched {launched}")
    if replayed != expected or any(launched.values()) or sum(c.plain_calls for c in counters.values()):
        raise AssertionError(f"{label}: the second drain did not replay its captured graphs alone")
    require_captured(srv._decode, f"{label} _decode")
    require_captured(srv._prefill, f"{label} _prefill")
    if results != first:
        raise AssertionError(f"{label}: the second drain gave other tokens than the first")
    agree = [tie_rule(f"{label} request {i}", r, reference[i], prompts[i], oracle) for i, r in enumerate(results)]
    log(f"{label}: every request's {SERVE_NEW} tokens against its own generate_from_prompt_fn: "
        f"{sum(a == SERVE_NEW for a in agree)} of {len(agree)} equal, the rest up to a tie")
    t = time_steps(srv._decode, N_DEC_TIMED, f"{label} _decode")
    log(f"{label}: {time.perf_counter() - t0:.1f} s from the second drain on")
    return dict(t, rate=n_tok / wall, launches=({k: 0 for k in COUNTED}, dict(replayed)), wall=wall, steps=steps)


def phase_decoder(seen=None) -> dict:
    """Path (g): the decoder served on the card (see the module docstring).
    Every function is compiled first, and K1 and K4 are held against their
    plain versions at its shapes before the loops run."""
    from aesara_tpu_torch.models.quant import quantize_decoder_int8
    from aesara_tpu_torch.models.serve import ContinuousBatcher

    t_start = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    lm, cpu = build_decoder("cuda"), build_decoder("cpu")
    oracle = last_logits_fn(cpu)
    qlm = quantize_decoder_int8(lm)
    gen = lm.generate_fn(n_steps=DEC_STEPS, t_max=DEC_T_MAX, mode=decoder_mode())
    genp = lm.generate_from_prompt_fn(prompt_len=DEC_PROMPT, n_new=DEC_NEW, t_max=DEC_T_MAX, mode=decoder_mode())
    genb = lm.generate_batched_fn(batch=DEC_BATCH, n_steps=DEC_STEPS, t_max=DEC_T_MAX, mode=decoder_mode())
    genq = qlm.generate_fn(n_steps=DEC_STEPS, t_max=DEC_T_MAX, mode=decoder_mode())
    smodel, scpu = build_decoder("cuda", SERVE_VOCAB), build_decoder("cpu", SERVE_VOCAB)
    servers = {chunk: ContinuousBatcher(smodel, n_slots=SERVE_SLOTS, t_max=SERVE_T_MAX, t_pad=SERVE_T_PAD,
                                        chunk=chunk, mode=decoder_mode()) for chunk in SERVE_CHUNKS}
    log(f"(g) DecoderLM({DEC_VOCAB}, {DEC_LAYERS}, {DEC_D}, {DEC_HEADS}, {DEC_FF}) and DecoderLM({SERVE_VOCAB}, ...) "
        f"on the card and the CPU, the int8 copy, and every function of (g) compiled: {time.perf_counter() - t0:.2f} s")

    # K1 on every Composite of (g) at its shapes, K4 at the decoder's softmaxes
    t0 = time.perf_counter()
    nodes = (decoder_composites(gen, (DEC_T_MAX,)) + decoder_composites(genp, (DEC_PROMPT,))
             + decoder_composites(genb, (DEC_BATCH, DEC_T_MAX)) + decoder_composites(genq, (DEC_T_MAX,)))
    for srv in servers.values():
        nodes += decoder_composites(srv._decode, (SERVE_SLOTS, SERVE_T_MAX))
        nodes += decoder_composites(srv._prefill, (SERVE_PROMPT, SERVE_PROMPT, SERVE_PROMPT))
    out["composites"] = check_decoder_composites(nodes, "(g)", seen)
    log(f"(g) K1 on {len(out['composites'])} distinct Composites: {time.perf_counter() - t0:.1f} s")
    rng = torch.Generator(device="cuda").manual_seed(24)
    out["k4"] = {name: check_k4(torch.randn(shape, device="cuda", dtype=torch.float64, generator=rng) * 3,
                                log_softmax=False)
                 for name, shape in (("g1 decode", (DEC_HEADS, DEC_T_MAX)),
                                     ("g3 batched", (DEC_BATCH * DEC_HEADS, DEC_T_MAX)),
                                     ("g2 prefill", (DEC_HEADS * DEC_PROMPT, DEC_PROMPT)))}

    # (g1) greedy KV-cache decode
    # unprofiled since PR 21 (its 16-token twin of phase 8 is profiled, captured and eager)
    g1 = run_decoder_fn(gen, lambda: gen(np.int64(DEC_FIRST)), "(g1) greedy decode", DEC_STEPS, DEC_STEPS,
                        profile=False)
    t0 = time.perf_counter()
    want = cpu_reference("decoder")["g1"]
    log(f"(g1) the same graph on the CPU: waited {time.perf_counter() - t0:.2f} s")
    g1["agree"] = tie_rule("(g1) greedy decode, card against CPU", g1["out"], want, [DEC_FIRST], oracle)
    log(f"(g1) greedy decode: {g1['agree']} of {DEC_STEPS} tokens agree with the CPU's")
    eager = lm.generate_fn(n_steps=DEC_CAPTURE_STEPS, t_max=DEC_T_MAX, mode=decoder_mode(False))
    cache = (DEC_T_MAX, DEC_HEADS, DEC_D // DEC_HEADS)
    n_copies, sizes = large_copies(lambda: eager(np.int64(DEC_FIRST)), cache)
    n_caches = 2 * DEC_LAYERS
    by_shape = {s: sizes.count(s) for s in sorted(set(sizes))}
    log(f"(g1) in place: copies of a {cache} cache in one eager call of the graph at {DEC_CAPTURE_STEPS} tokens: "
        f"{n_copies} (the Alloc of the zeros the caches start from, and the loop's copy of each of its {n_caches} "
        f"caches once a call; a clone a step would make {n_caches * DEC_CAPTURE_STEPS} more); every copy of 1 MiB "
        f"or more, by shape: {by_shape}")
    if n_copies > n_caches + 1:
        raise AssertionError(f"(g1): {n_copies} copies of a cache's size in a call: the caches are copied per step")
    g1["cache_copies"] = n_copies
    out["g1"] = g1
    del eager
    release()

    # (g2) prompt prefill, then decode
    prompt = (np.arange(DEC_PROMPT, dtype="int64") * 7) % DEC_VOCAB
    g2 = run_decoder_fn(genp, lambda: genp(prompt), "(g2) prompt prefill + decode", DEC_NEW - 1, DEC_PROMPT,
                        unit="prompt tokens")
    want = _host(cpu.generate_from_prompt_fn(DEC_PROMPT, DEC_NEW, DEC_T_MAX, mode=decoder_mode(device="cpu"))(prompt))
    g2["agree"] = tie_rule("(g2) prompt, card against CPU", g2["out"], want, list(prompt), oracle)
    out["g2"] = g2
    del genp
    release()

    # (g3) batched decode: 32 streams
    firsts = np.arange(DEC_BATCH, dtype="int64")
    # (g3) and (g4) unprofiled: a decode loop's session costs 20-28 s, and
    # the smoke's 1,200 s take path (l) since PR 21 ((g1)'s stays)
    g3 = run_decoder_fn(genb, lambda: genb(firsts), "(g3) batched decode", DEC_STEPS, DEC_BATCH * DEC_STEPS,
                        profile=False)
    g3["agree"] = [tie_rule(f"(g3) stream {j} against single-stream decode", g3["out"][:, j],
                            _host(gen(np.int64(j))), [j], oracle) for j in range(2)]
    out["g3"] = g3
    del genb
    release()

    # (g4) int8 weights
    g4 = run_decoder_fn(genq, lambda: genq(np.int64(DEC_FIRST)), "(g4) int8 greedy decode", DEC_STEPS, DEC_STEPS,
                        profile=False)
    same = int(np.sum(g4["out"][:DEC_INT8_COMPARED] == g1["out"][:DEC_INT8_COMPARED]))
    lead = next((i for i in range(DEC_INT8_COMPARED) if g4["out"][i] != g1["out"][i]), DEC_INT8_COMPARED)
    log(f"(g4) int8 against float32 weights, first {DEC_INT8_COMPARED} tokens: {same} equal, the first {lead} in a "
        f"row (random weights: the JAX package holds agreement only on a trained model)")
    g4["agree"] = same
    out["g4"] = g4
    del gen, genq, qlm
    release()

    # (g5) continuous batching at bench_serving.py's settings
    t0 = time.perf_counter()
    soracle = last_logits_fn(scpu)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, SERVE_VOCAB, size=SERVE_PROMPT).astype("int64") for _ in range(SERVE_SLOTS)]
    ref_fn = smodel.generate_from_prompt_fn(SERVE_PROMPT, SERVE_NEW, SERVE_T_MAX, mode=decoder_mode())
    reference = [[int(v) for v in _host(ref_fn(p))] for p in prompts]
    log(f"(g5) the {SERVE_SLOTS} per-request references: {time.perf_counter() - t0:.2f} s")
    del ref_fn
    for chunk, srv in servers.items():
        out[f"g5c{chunk}"] = run_batcher(srv, chunk, prompts, f"(g5) continuous batching, chunk {chunk}", soracle,
                                         reference)
    del servers, srv
    release()
    log(f"(g) decoder paths: {time.perf_counter() - t_start:.2f} s")
    return out


def check_decoder_composites(nodes, label: str = "(g)", seen=None, time_each: bool = True) -> list:
    """K1 on each distinct Composite of a decoder path (by its scalar ops and
    its inputs' shapes and dtypes) against its plain version at the shapes
    the path gives it, each timed unless ``time_each`` is off; ``seen``
    (updated) holds the ones checked before."""
    time_each = True if time_each else None
    seen = set() if seen is None else seen
    rows = []
    for node, full in nodes:
        full = full + (1,) * 5
        ops = ".".join(sorted(type(n.op).__name__ for n in node.op.scalar_op.nodes))
        key = (ops, tuple((tuple(s if s is not None else full[d] for d, s in enumerate(v.type.shape)), v.type.dtype)
                          for v in node.inputs))
        if key in seen:
            continue
        seen.add(key)
        rows += check_composites([node], label, np.random.default_rng(51), full=full, time_each=time_each)
    return rows


def gumbel_uniforms(key) -> np.ndarray:
    """The uniforms of the sampled decode's draw from ``key`` (the key
    before the draw), as the graph makes them: JAX's float64 uniforms
    from the threefry plain version, moved onto [1e-6, 1 - 1e-6] and
    rounded to float32."""
    from aesara_tpu_torch.link.torch.kernels.threefry import threefry_plain

    _, u = threefry_plain(torch.as_tensor(np.asarray(key, dtype=np.uint32)), (DEC_VOCAB,), "float64")
    low, high = np.float32(1e-6), np.float32(1.0 - 1e-6)
    return (u.numpy() * np.float64(high - low) + np.float64(low)).astype("float32")


def noisy_scores(logits, u, top_k: int) -> np.ndarray:
    """The scores whose argmax a sampled decode step takes, in float64:
    ``logits`` / T minus log(-log ``u``); below the top-k -inf (the graph
    puts -1e9 there before the noise, which no kept score can lose to)."""
    scores = logits / SAMPLE_T - np.log(-np.log(u)).astype("float64")
    if top_k:
        scores = np.where(logits >= np.sort(logits)[-top_k], scores, -np.inf)
    return scores


def sample_tie_rule(label: str, got, want, prefix, oracle, key, top_k: int) -> int:
    """The tie rule of a sampled decode: ``got`` against ``want``, equal up
    to a first difference at a step where the CPU's scores of the two
    tokens (``noisy_scores`` of its logits and that step's uniforms, from
    the host's key chain of the loop from ``key``, the key at the call's
    start) differ by under TIE_REL of the scores' scale, the largest
    finite one.  A token below the top-k scores -inf: never a tie."""
    got, want = [int(t) for t in got], [int(t) for t in want]
    if got == want:
        return len(got)
    k = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    logits = _host(oracle(np.asarray(list(prefix) + want[:k], dtype="int64"))).astype("float64")
    scores = noisy_scores(logits, gumbel_uniforms(key_after(key, k)), top_k)
    gap = abs(float(scores[want[k]] - scores[got[k]]))
    scale = float(np.abs(scores[np.isfinite(scores)]).max())
    log(f"{label}: first difference at token {k} ({got[k]} against {want[k]}); their noisy scores differ by "
        f"{gap:.3e} there, {gap / scale:.3e} of the scores' scale (tie rule: under {TIE_REL})")
    if not gap < TIE_REL * scale:
        raise AssertionError(f"{label}: token {k} differs ({got[k]} against {want[k]}) where the gap of their "
                             f"scores {gap:.3e} is not a tie")
    return k


def path_scores(oracle, prompt, toks) -> tuple:
    """The summed log-probability of ``toks`` after ``prompt`` from the
    oracle's logits at each step, by an fp64 path and by an fp32 one (the
    logits rounded to float32, their log-softmax and the sum in float32)."""
    s64, s32 = 0.0, np.float32(0.0)
    for t, tok in enumerate(toks):
        logits = _host(oracle(np.concatenate([prompt, np.asarray(toks[:t], dtype="int64")])))
        l64 = logits.astype("float64")
        s64 += float(l64[tok] - (l64.max() + np.log(np.sum(np.exp(l64 - l64.max())))))
        l32 = logits.astype("float32")
        lse32 = l32.max() + np.log(np.sum(np.exp(l32 - l32.max()), dtype=np.float32))
        s32 = np.float32(s32 + (l32[tok] - lse32))
    return s64, float(s32)


def check_threefry() -> dict:
    """The threefry kernel bitwise against its plain version at TF_SIZES
    values in each mode (32 and 64 bits, float32 and float64 on [0, 1)),
    from keys of seeds 0 and 42 and an all-ones key, its next key against
    the host's; then its time at the decoder's draw, (32000,) in float64
    (the sampling path's) and float32, against the plain version's, with
    its bound: the larger of the bytes it writes over the memory rate and
    its integer operations, TF_HASH_OPS a value, at INT32_OPS."""
    from aesara_tpu_torch.link.torch.kernels.threefry import MODES, threefry_draw, threefry_plain
    from aesara_tpu_torch.tensor.random.op import prng_key, split

    keys = {"seed 0": prng_key(0), "seed 42": prng_key(42), "all ones": np.full(2, 0xFFFFFFFF, np.uint32)}
    t0 = time.perf_counter()
    checked = 0
    for name, data in keys.items():
        key = torch.as_tensor(data).cuda()
        for n in TF_SIZES:
            for mode in MODES:
                nk, out = threefry_draw(key, (n,), mode)
                pk, want = threefry_plain(key, (n,), mode)
                torch.cuda.synchronize()
                if not (torch.equal(nk.view(torch.int32), pk.view(torch.int32)) and torch.equal(out, want)
                        and np.array_equal(nk.cpu().numpy(), split(data)[0])):
                    raise AssertionError(f"threefry kernel, key {name}, {n} values, {mode}: not its plain version's "
                                         f"bits")
                checked += 1
    log(f"threefry kernel: {checked} draws ({len(keys)} keys x {TF_SIZES} values x {MODES}) bitwise equal to "
        f"the plain version, next keys the host's: {time.perf_counter() - t0:.2f} s")
    key = torch.as_tensor(prng_key(0)).cuda()
    res = {"max_abs_err": 0.0, "library_ms": None}
    for mode in ("float64", "float32"):
        ms = device_ms(lambda: threefry_draw(key, (DEC_VOCAB,), mode))
        plain_ms = device_ms(lambda: threefry_plain(key, (DEC_VOCAB,), mode))
        width = 8 if mode == "float64" else 4
        b_ms, b_by = bound(2 * 8 + DEC_VOCAB * width, DEC_VOCAB * TF_HASH_OPS, INT32_OPS)
        log(f"threefry kernel at ({DEC_VOCAB},) {mode}: {ms:.4f} ms, plain version {plain_ms:.4f} ms, bound "
            f"{b_ms:.5f} ms ({b_by}); no PyTorch call computes threefry2x32")
        res[mode] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    res.update(res["float64"])
    return res


def prepare_sampling(seen: set) -> dict:
    """Path (h)'s set-up (see the module docstring): the threefry kernel
    held against its plain version and timed, the models and every
    function of (h) compiled, K1 on every Composite of (h) (but those in
    ``seen``, updated) and K4 at its new softmax widths against their
    plain versions.  The main run makes it before path (g): late in the
    run, after (g)'s profiles of 50,000-kernel calls, the profiler's
    sessions came back empty or with kernels of a fifth of their time
    (PERF.md section 7), so the kernels are timed first."""
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models.decoder import DecoderLM

    t_start = time.perf_counter()
    out = {"tf": check_threefry()}
    t0 = time.perf_counter()
    lm, cpu = build_decoder("cuda"), build_decoder("cpu")
    with config.change_flags(floatX="float32"):
        draft = DecoderLM(DEC_VOCAB, SPEC_DRAFT_LAYERS, DEC_D, DEC_HEADS, DEC_FF, seed=1)
        fns = dict(sampled={k: lm.generate_fn(DEC_STEPS, DEC_T_MAX, temperature=SAMPLE_T, top_k=k,
                                              mode=decoder_mode()) for k in (0, SAMPLE_TOPK)},
                   spec=lm.speculative_generate_fn(draft, DEC_PROMPT, SPEC_NEW, DEC_T_MAX, n_spec=SPEC_N,
                                                   mode=decoder_mode()),
                   spec_self=lm.speculative_generate_fn(lm, DEC_PROMPT, SPEC_SELF_NEW, DEC_T_MAX, n_spec=SPEC_N,
                                                        mode=decoder_mode()),
                   beam=lm.beam_search_fn(DEC_PROMPT, BEAM_NEW, DEC_T_MAX, beam=BEAM, mode=decoder_mode()),
                   beam_one=lm.beam_search_fn(DEC_PROMPT, BEAM_ONE_NEW, DEC_T_MAX, beam=1, mode=decoder_mode()))
    log(f"(h) the draft DecoderLM({DEC_VOCAB}, {SPEC_DRAFT_LAYERS}, ...) and every function of (h) compiled: "
        f"{time.perf_counter() - t0:.2f} s")
    for label in ("spec", "spec_self"):
        blocker = fns[label].fn.capture_blocker
        if blocker is None or "until" not in blocker:
            raise AssertionError(f"(h2) {label}: expected to run eagerly (its until), blocker {blocker}")
    t0 = time.perf_counter()
    sampled = fns["sampled"]
    nodes = (decoder_composites(sampled[0], (DEC_VOCAB,)) + decoder_composites(sampled[SAMPLE_TOPK], (DEC_VOCAB,))
             + decoder_composites(fns["spec"], (SPEC_N, DEC_T_MAX))
             + decoder_composites(fns["beam"].function, (BEAM, DEC_T_MAX)))
    out["composites"] = check_decoder_composites(nodes, "(h)", seen)
    log(f"(h) K1 on {len(out['composites'])} distinct Composites not checked before: "
        f"{time.perf_counter() - t0:.1f} s")
    rng = torch.Generator(device="cuda").manual_seed(25)
    out["k4"] = {name: check_k4(torch.randn(shape, device="cuda", dtype=torch.float64, generator=rng) * 3,
                                log_softmax=False)
                 for name, shape in (("h3 beam", (BEAM * DEC_HEADS, DEC_T_MAX)),
                                     ("h2 verify block", (SPEC_N * DEC_HEADS, DEC_T_MAX)))}
    out.update(fns, lm=lm, cpu=cpu, draft=draft, setup_s=time.perf_counter() - t_start)
    return out


def beam_prompt(m: int) -> np.ndarray:
    """(h3)'s prompt of stride ``m``: (arange(256) * m) % 32000."""
    return (np.arange(DEC_PROMPT, dtype="int64") * m) % DEC_VOCAB


def cpu_decoder_references() -> dict:
    """Paths (g)'s and (h)'s CPU side, made in ``cpu_reference``'s process:
    (g1)'s 256 greedy tokens; (h1)'s from call 3's key (the host's after
    N_DEC_CALLS - 1 draws from the stream's first), alone and with top-k;
    (h3)'s best sequence and score at each of BEAM_PROMPT_STRIDES' prompts,
    and the first one's tokens scored by ``path_scores``."""
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.tensor.random.op import fold_in, prng_key

    t0 = time.perf_counter()
    cpu = build_decoder("cpu")
    refs = {"g1": _host(cpu.generate_fn(DEC_STEPS, DEC_T_MAX, mode=decoder_mode(device="cpu"))(np.int64(DEC_FIRST)))}
    for k in (0, SAMPLE_TOPK):
        with config.change_flags(device="cpu", floatX="float32"):
            ref = cpu.generate_fn(DEC_STEPS, DEC_T_MAX, temperature=SAMPLE_T, top_k=k, mode=decoder_mode(device="cpu"))
        rng_key(ref).set_value(key_after(fold_in(prng_key(0), 0), N_DEC_CALLS - 1))
        refs[f"h1k{k}"] = _host(ref(np.int64(DEC_FIRST)))
    with config.change_flags(device="cpu", floatX="float32"):
        beam = cpu.beam_search_fn(DEC_PROMPT, BEAM_NEW, DEC_T_MAX, beam=BEAM, mode=decoder_mode(device="cpu"))
    refs["h3"] = {m: beam(beam_prompt(m)) for m in BEAM_PROMPT_STRIDES}
    first = BEAM_PROMPT_STRIDES[0]
    refs["h3_paths"] = path_scores(last_logits_fn(cpu), beam_prompt(first), refs["h3"][first][0])
    refs["seconds"] = time.perf_counter() - t0
    return refs


_CPU_REFS: dict = {}


def _cpu_ref_worker():
    torch.set_num_threads(CPU_REF_THREADS)


def start_cpu_references(*names):
    """Start the jobs ``names`` of CPU_REF_JOBS, in that order, in one
    spawned process (it touches no CUDA); at exit it is ended."""
    import atexit
    import multiprocessing

    pool = multiprocessing.get_context("spawn").Pool(1, initializer=_cpu_ref_worker)
    atexit.register(pool.terminate)
    _CPU_REFS.update(pool=pool, jobs={name: pool.apply_async(CPU_REF_JOBS[name]) for name in names})


def cpu_reference(name: str) -> dict:
    """Job ``name``'s result (see CPU_REF_JOBS), waited for; the job is
    started here where ``start_cpu_references`` did not start it."""
    if name not in _CPU_REFS.get("jobs", {}):
        stop_cpu_references()
        start_cpu_references(name)
    t0 = time.perf_counter()
    result = _CPU_REFS["jobs"][name].get()
    log(f"CPU reference {name!r}: made in {result['seconds']:.2f} s in its own process, waited "
        f"{time.perf_counter() - t0:.2f} s for it")
    return result


def stop_cpu_references():
    """End ``cpu_reference``'s process once its jobs are done."""
    pool = _CPU_REFS.pop("pool", None)
    if pool is not None:
        pool.close()
        pool.join()
    _CPU_REFS.clear()


def phase_sampling(prep: dict, greedy=None) -> dict:
    """Path (h)'s runs, on what ``prepare_sampling`` made (see the module
    docstring); ``greedy``: (g1)'s tokens, else (h) decodes them itself.
    Returns the set-up's checks and each sub-path's results."""
    from aesara_tpu_torch.tensor.random.op import fold_in, prng_key

    t_start = time.perf_counter()
    out = {k: prep[k] for k in ("tf", "composites", "k4")}
    lm, cpu, sampled = prep["lm"], prep["cpu"], prep.pop("sampled")
    spec, spec_self, beam, beam_one = (prep.pop(k) for k in ("spec", "spec_self", "beam", "beam_one"))
    oracle = last_logits_fn(cpu)

    # (h1) sampling: each call advances the key once (the stream's default
    # update draws outside the loop, as in the JAX package), so each call
    # draws other noise; call 3 (a replay) against the CPU from the same key
    key0 = fold_in(prng_key(0), 0)
    prompt = beam_prompt(BEAM_PROMPT_STRIDES[0])
    refs = cpu_reference("decoder")
    if greedy is None:
        greedy = _host(lm.generate_fn(DEC_STEPS, DEC_T_MAX, mode=decoder_mode(False))(np.int64(DEC_FIRST)))
    for k, fn in sampled.items():
        label = f"(h1) sampled decode, T {SAMPLE_T}" + (f", top-k {k}" if k else "")
        key = rng_key(fn)
        calls = [0]

        def counted(fn=fn):
            calls[0] += 1
            return fn(np.int64(DEC_FIRST))

        # top-k's run unprofiled (a decode loop's session costs 20-30 s; its
        # phase-8 twin at 16 tokens is profiled), room for path (l) since PR 21
        r = run_decoder_fn(fn, counted, label, DEC_STEPS, DEC_STEPS, sampled=True, profile=not k)
        if r["launches"][0]["TF"] != 2 * (DEC_STEPS + 1):
            raise AssertionError(f"{label}: {r['launches'][0]['TF']} threefry launches in the eager and capture "
                                 f"calls, expected {2 * (DEC_STEPS + 1)}")
        check_key(key, key0, calls[0], f"{label}, every call")
        want = refs[f"h1k{k}"]
        r["agree"] = sample_tie_rule(f"{label}, call {N_DEC_CALLS} (a replay), card against CPU",
                                     r["outs"][-1], want, [DEC_FIRST], oracle,
                                     key_after(key0, N_DEC_CALLS - 1), k)
        same = int(np.sum(r["outs"][0] == greedy))
        log(f"{label}: {r['agree']} of {DEC_STEPS} tokens of call {N_DEC_CALLS} agree with the "
            f"CPU's; the calls differ from each other; call 1 shares {same} of {DEC_STEPS} tokens with greedy decode")
        if same == DEC_STEPS:
            raise AssertionError(f"{label}: the sampled tokens are the greedy ones")
        out[f"h1k{k}"] = r
    del sampled
    release()

    # (h2) speculative decoding: a while-Scan, eager; against the target's
    # own greedy decode of the same prompt on the card
    for label, fn, n_new in ((f"(h2) speculative, a {SPEC_DRAFT_LAYERS}-layer draft", spec, SPEC_NEW),
                             ("(h2) speculative, self-draft", spec_self, SPEC_SELF_NEW)):
        ref_fn = lm.generate_from_prompt_fn(DEC_PROMPT, n_new, DEC_T_MAX, mode=decoder_mode())
        want = _host(ref_fn(prompt))
        torch.cuda.synchronize()
        zero_counters()
        secs, toks = [], []
        for _ in range(N_SPEC_CALLS):
            t0 = time.perf_counter()
            toks.append(_host(fn(prompt)))
            secs.append(time.perf_counter() - t0)
        counters = _all_counters()
        launched = {k: counters[k].launches for k in COUNTED if counters[k].launches}
        for o in toks[1:]:
            if not np.array_equal(o, toks[0]):
                raise AssertionError(f"{label}: calls gave other tokens")
        agree = tie_rule(f"{label}, against the target's greedy decode", toks[0], want, list(prompt), oracle)
        rate = n_new / min(secs) if secs else 0.0
        log(f"{label}: {N_SPEC_CALLS} eager calls {', '.join(f'{t:.3f}' for t in secs)} s ({n_new} tokens a call: "
            f"{rate:.1f} tokens/s at the fastest); launches in them {launched}; {agree} of {n_new} tokens agree "
            f"with generate_from_prompt_fn ({fn.fn.capture_blocker})")
        out["h2" + ("self" if fn is spec_self else "")] = dict(secs=secs, rate=rate, agree=agree, launches=launched)
        del ref_fn
    del spec, spec_self
    prep.pop("draft")
    release()

    # (h3) beam search, captured; the CPU's tokens and score; beam 1 gives
    # the target's greedy tokens
    f = beam.function
    r = run_decoder_fn(f, lambda: f(prompt), f"(h3) beam search, {BEAM} beams", BEAM_NEW - 1, BEAM_NEW)
    rels = []
    for m in BEAM_PROMPT_STRIDES:
        (got, score), (want, want_score) = beam(beam_prompt(m)), refs["h3"][m]
        rels.append(abs(score - want_score) / abs(want_score))
        log(f"(h3) beam search, prompt (arange * {m}) % {DEC_VOCAB}: score {score:.12f}, the CPU's "
            f"{want_score:.12f} ({rels[-1]:.3e} relative; tolerance {BEAM_SCORE_REL}); tokens "
            f"{'equal' if got == want else 'differ'}")
        if got != want or not rels[-1] < BEAM_SCORE_REL:
            raise AssertionError(f"(h3) beam search: tokens {got} score {score}, the CPU's {want} {want_score}")
        if m == BEAM_PROMPT_STRIDES[0]:
            r.update(score=score, tokens=got, cpu_score=want_score)
    s64, s32 = refs["h3_paths"]
    rel64, rel32 = (abs(v - r["cpu_score"]) / abs(r["cpu_score"]) for v in (s64, s32))
    log(f"(h3) the CPU's tokens' score from its logits on the host: fp64 path {s64:.12f} ({rel64:.3e} relative to "
        f"the CPU's beam score), fp32 path {s32:.12f} ({rel32:.3e})")
    if not rel64 < BEAM_SCORE_REL <= rel32:
        raise AssertionError(f"(h3) the tolerance {BEAM_SCORE_REL} does not part the fp64 path ({rel64:.3e}) from "
                             f"the fp32 one ({rel32:.3e})")
    one, _ = beam_one(prompt)
    g2 = _host(lm.generate_from_prompt_fn(DEC_PROMPT, DEC_NEW, DEC_T_MAX, mode=decoder_mode())(prompt))
    r["agree_one"] = tie_rule("(h3) beam 1 against (g2)'s greedy tokens", one, g2[:BEAM_ONE_NEW], list(prompt),
                              oracle)
    r.update(score_rel=max(rels), score_rels=rels, fp64_path_rel=rel64, fp32_path_rel=rel32)
    out["h3"] = r
    del beam, beam_one, f
    release()
    log(f"(h) sampling, speculative and beam paths: {prep['setup_s']:.2f} s of set-up and checks, "
        f"{time.perf_counter() - t_start:.2f} s of runs")
    return out


def decoder_sampling_only():
    """--decoder-sampling: the setup and path (h) alone."""
    phase_setup()
    start_cpu_references("decoder")
    phase_sampling(prepare_sampling(set()))
    stop_cpu_references()
    log("chip_smoke --decoder-sampling: path (h) passed")


def decoder_only():
    """--decoder: the setup and path (g) alone."""
    phase_setup()
    start_cpu_references("decoder")
    phase_decoder()
    stop_cpu_references()
    log("chip_smoke --decoder: path (g) passed")


# ---------------------------------------------------------------------------
# (i) bfloat16 graphs, remat and the decoder LM trained
# ---------------------------------------------------------------------------

def card_tensor(arr, dtype: str, device="cuda"):
    """A NumPy array as a tensor of ``dtype`` on ``device``, through the
    port's user form of the dtype (``scalar.ops.from_host``)."""
    from aesara_tpu_torch.scalar.ops import from_host

    return torch.as_tensor(from_host(arr, dtype)).to(device)


def build_bf16_step(device: str, n_layers: int = N_LAYERS, d: int = D_MODEL, heads: int = N_HEADS,
                    ff: int = D_FF, batch: int = BATCH, seq: int = SEQ, use_remat: bool = False, use_graph=None,
                    with_grads: bool = False, dtype: str = "bfloat16", loss_dtype: str = None):
    """``benchmarks/bench_transformer.py``'s ``build_step`` in bfloat16 on
    the port: ``n_layers`` encoder layers of seeds 0.., x a shared
    ``normal(size=(batch, seq, d)) * 0.1`` of ``default_rng(0)`` (its first
    ``batch`` rows), loss mean(h²) returned on the card, sgd at LR, and
    with ``use_remat`` each layer a ``remat`` node: (step, parameters), and
    with ``with_grads`` a third function, without updates, that returns
    the loss and the gradient of each parameter.  In another ``dtype`` the
    graph starts from the same bfloat16 values of x and the weights.  With
    ``loss_dtype`` the loss is the mean of h² cast to it: an fp16 mean over
    more than 65,504 values is NaN in both packages (the count is inf in
    fp16), so (l3)'s fp16 step takes its loss in float32."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch.compile.builders import remat
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.gradient import grad
    from aesara_tpu_torch.models.optim import sgd
    from aesara_tpu_torch.models.transformer import TransformerEncoderLayer
    from aesara_tpu_torch.scalar.ops import from_host, to_host
    from aesara_tpu_torch.tensor import math as tm

    def bf16_start(value):
        return from_host(to_host(value, "bfloat16"), dtype)

    xv = np.random.default_rng(0).normal(size=(BATCH, seq, d))[:batch] * 0.1
    with config.change_flags(device=device, floatX=dtype):
        layers = [TransformerEncoderLayer(d, heads, ff, seed=i) for i in range(n_layers)]
        params = [p for layer in layers for p in layer.params]
        if dtype != "bfloat16":
            for p in params:
                p.set_value(bf16_start(p.value))
        x = ptp.shared(bf16_start(xv), name="x")
        h = x
        for layer in layers:
            h = remat([h] + layer.params, [layer(h)])(h, *layer.params) if use_remat else layer(h)
        loss = tm.mean(tm.sqr(h if loss_dtype is None else tm.cast(h, loss_dtype)))
        mode = ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph))
        step = ptp.function([], ptp.Out(loss, borrow=True), updates=sgd(loss, params, lr=LR), mode=mode)
        if not with_grads:
            return step, params
        return step, params, ptp.function([], [loss] + grad(loss, params), mode=mode)


def graph_launches(fn) -> dict:
    """The launches of one call of a compiled function, read from its
    graph: K1 a Composite run on the card, K2 a FusedAttention and a
    FusedAttentionGrad (its recompute), K3 a FusedAttentionGrad, K4 a
    Softmax or LogSoftmax, in the step's program and in the inner programs
    of its OpFromGraph (Remat) nodes."""
    from aesara_tpu_torch.compile.builders import OpFromGraph
    from aesara_tpu_torch.scalar.composite import Composite

    counts = {"K1": 0, "K2": 0, "K3": 0, "K4": 0}

    def walk(program):
        for node, fold, lowered in zip(program.order, program.folds, program.fns):
            name = type(node.op).__name__
            if fold:
                continue
            if isinstance(getattr(node.op, "scalar_op", None), Composite):
                counts["K1"] += 1
            elif name in ("FusedAttention", "FusedAttentionGrad"):
                counts["K2"] += 1
                counts["K3"] += name == "FusedAttentionGrad"
            elif name in ("Softmax", "LogSoftmax"):
                counts["K4"] += 1
            elif isinstance(node.op, OpFromGraph):
                walk(lowered.program)

    walk(fn.fn.program)
    return counts


def op_census(fn) -> dict:
    """Nodes of the step's graph by op (Composites as one), for the log."""
    names = [type(n.op).__name__ for n in fn.fn.program.order]
    return {k: names.count(k) for k in ("Remat", "RematBarrier", "FusedAttention", "FusedAttentionGrad",
                                        "Dot", "Dot22Scalar")}


def counted_steps(step, label: str, n: int = N_TRAIN_STEPS, dtype=torch.bfloat16):
    """``n`` calls of a train step with the counters set to 0 just before
    and read just after (every kernel of the step's graph launched as its
    graph says): the losses as floats."""
    per_call = graph_launches(step)
    torch.cuda.synchronize()
    zero_counters()
    losses = []
    for _ in range(n):
        loss = step()
        if not (loss.is_cuda and loss.shape == () and loss.dtype == dtype):
            raise AssertionError(f"{label}: loss {loss} is not a {dtype} scalar on the card")
        losses.append(float(loss))
    torch.cuda.synchronize()
    launches = read_counters(per_call, label, n)
    log(f"{label} losses: {losses}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: loss not finite: {losses}")
    return losses, launches, per_call


def check_attention(shape, dtype=torch.bfloat16) -> dict:
    """K2 and K3 at one (BH, T, D) panel, non-causal: each against its
    plain version within ATTENTION_REL[dtype] of the plain output's scale,
    two calls with the same bits, device ms of the kernel, the plain
    version and the library (scaled_dot_product_attention on the panel's
    ``sdpa_view``, its backend named; for K3 the fastest backward it
    offers, ``sdpa_backward_ms``),
    and the bound: q, k, v (and dO) read, the outputs written, the
    products at the card's dense rate for the type (bf16 and fp16 alike;
    fp32 as three TF32 products, the kernels' 3xTF32)."""
    from aesara_tpu_torch.link.torch.kernels.attention import (
        attention_grads_plain, attention_plain, flash_attention, flash_attention_grads,
    )

    BH, T, D = shape
    name = {torch.float32: "fp32", torch.bfloat16: "bf16", torch.float16: "fp16"}[dtype]
    rel = ATTENTION_REL[dtype]
    gen = torch.Generator(device="cuda").manual_seed(16)
    q, k, v, do = (torch.randn(shape, device="cuda", generator=gen).to(dtype) for _ in range(4))
    scale = 1.0 / D ** 0.5
    out = flash_attention(q, k, v, scale=scale)
    want = attention_plain(q, k, v, False, scale)
    k2_err = (out.float() - want.float()).abs().max().item()
    if not k2_err <= rel * want.float().abs().max().item():
        raise AssertionError(f"K2 {name} {shape}: max err {k2_err}")
    grads = flash_attention_grads(q, k, v, do, scale=scale)
    k3_err = 0.0
    for g_name, g, w in zip(("dq", "dk", "dv"), grads, attention_grads_plain(q, k, v, do, False, scale)):
        err = (g.float() - w.float()).abs().max().item()
        if g.dtype != dtype or not err <= rel * w.float().abs().max().item():
            raise AssertionError(f"K3 {name} {shape} {g_name}: {g.dtype}, max err {err}")
        k3_err = max(k3_err, err)
    del want
    if not (torch.equal(out, flash_attention(q, k, v, scale=scale))
            and all(torch.equal(a, b) for a, b in zip(grads, flash_attention_grads(q, k, v, do, scale=scale)))):
        raise AssertionError(f"K2/K3 {name} {shape}: two calls gave different bits")
    del out, grads
    size = q.element_size()
    flops, rate = (3, TF32_FLOPS) if dtype == torch.float32 else (1, BF16_FLOPS)
    k2 = {"max_abs_err": k2_err, "ms": device_ms(lambda: flash_attention(q, k, v, scale=scale)),
          "plain_ms": device_ms(lambda: attention_plain(q, k, v, False, scale), reps=5)}
    k2["library_ms"], names = library_split(f"K2 {name}", lambda: torch.nn.functional.scaled_dot_product_attention(
        *(sdpa_view(t) for t in (q, k, v)), scale=scale))
    k2["library"] = sdpa_backend(names)
    k2["bound_ms"], k2["bound_by"] = bound(4 * q.numel() * size, flops * 4 * BH * T * T * D, rate)
    split = device_split(lambda: flash_attention_grads(q, k, v, do, scale=scale), reps=10)
    k3 = {"max_abs_err": k3_err, "ms": sum(split.values()),
          "backward_ms": sum(t for name, t in split.items() if "flash_bwd" in name),
          "plain_ms": device_ms(lambda: attention_grads_plain(q, k, v, do, False, scale), reps=3)}
    k3["library_ms"], k3["library"] = sdpa_backward_ms(q, k, v, do, scale)
    # q, k, v, dO read, dQ, dK, dV written; the S, dP, dV, dQ, dK products
    k3["bound_ms"], k3["bound_by"] = bound(7 * q.numel() * size, flops * 10 * BH * T * T * D, rate)
    for kernel, r in (("K2", k2), ("K3", k3)):
        extra = f", backward kernels {r['backward_ms']:.4f}" if "backward_ms" in r else ""
        log(f"{kernel} {name} {shape}: max_abs_err {r['max_abs_err']:.3e} (tolerance {rel} x max|plain|), two "
            f"calls the same bits; device ms kernel {r['ms']:.4f}{extra}, plain {r['plain_ms']:.4f}, library "
            f"({r['library']}) {r['library_ms']}, bound {r['bound_ms']:.4f} ({r['bound_by']})")
    return {"K2": k2, "K3": k3}


def sdpa_view(t):
    """A (BH, T, D) panel as scaled_dot_product_attention's (8, BH / 8, T,
    D): its kernels put the heads on a grid dimension of at most 65,535
    blocks, so (1, BH, T, D) fails past 65,535 batch-heads."""
    return t.reshape(8, t.shape[0] // 8, *t.shape[1:])


def sdpa_backward_ms(q, k, v, do, scale) -> tuple:
    """(device ms, backend) of the fastest backward that PyTorch's
    scaled_dot_product_attention offers on K3's inputs, viewed as (8,
    BH / 8, T, D): under each of its cuDNN, flash and memory-efficient
    backends that takes them, the forward runs once outside the timed
    window and autograd's backward (dQ, dK, dV from dO) is timed; (None,
    None) where none takes them."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [sdpa_view(t).detach().requires_grad_() for t in (q, k, v)]
    do4 = do.reshape(leaves[0].shape)
    times = {}
    for backend, name in ((SDPBackend.CUDNN_ATTENTION, "cuDNN"), (SDPBackend.FLASH_ATTENTION, "flash"),
                          (SDPBackend.EFFICIENT_ATTENTION, "memory-efficient")):
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                out = torch.nn.functional.scaled_dot_product_attention(*leaves, scale=scale)
        except RuntimeError as exc:
            log(f"K3 library {name} backward not timed: {str(exc)[:200]}")
            continue
        ms, names = library_split(f"K3 library {name} backward", lambda: torch.autograd.grad(
            out, leaves, do4, retain_graph=True))
        del out
        if ms is not None:
            times[name] = ms
            log(f"K3 library {name} backward {tuple(leaves[0].shape)} {q.dtype}: device ms {ms:.4f} "
                f"({', '.join(n[:60] for n in names)})")
    if not times:
        return None, None
    best = min(times, key=times.get)
    return times[best], f"{best} backward"


def bf16_cpu_reference(dtype: str = "bfloat16") -> dict:
    """(i1)'s CPU twin, made in ``cpu_reference``'s process ((l3)'s with
    ``dtype`` float16): at batch 1, the loss and the gradients of the
    step, and every parameter after one step (in float32, which holds a
    bfloat16 or float16 exactly); and how far each of those gradients is
    from the same gradient in float64 from the same bfloat16 start
    (``own``: the CPU's own distance from exact arithmetic)."""
    t0 = time.perf_counter()
    loss_dtype = "float32" if dtype == "float16" else None
    step, params, grads = build_bf16_step("cpu", batch=1, with_grads=True, dtype=dtype, loss_dtype=loss_dtype)
    g = [v.float().numpy() for v in grads()]
    loss = float(step())
    exact = build_bf16_step("cpu", batch=1, with_grads=True, dtype="float64")[2]()
    own = [float(np.abs(a - b.numpy()).max()) for a, b in zip(g, exact)]
    return {"loss": loss, "grads": g, "own": own, "params": [(p.name, p.value.float().numpy()) for p in params],
            "seconds": time.perf_counter() - t0}


def compare_bf16(label: str, got, want, names, own=None, rel: float = BF16_REL):
    """Each pair of tensors within ``rel`` (BF16_REL unless given) of the
    reference's scale (its largest magnitude), plus, where ``own`` gives
    it, the reference's own distance from exact arithmetic; logs the worst
    relative error."""
    worst, beyond = 0.0, []
    for k, (name, g, w) in enumerate(zip(names, got, want)):
        g, w = torch.as_tensor(g).double().cpu(), torch.as_tensor(w).double()
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        err_rel = err / scale if scale else err
        extra = 0.0 if own is None else own[k]
        if g.shape != w.shape or not err <= rel * (scale or 1.0) + extra:
            raise AssertionError(f"{label}: {name} {tuple(g.shape)} off by {err_rel:.3e} of its scale (own distance "
                                 f"from exact {extra:.3e})")
        worst = max(worst, err_rel)
        if err_rel > rel:
            beyond.append(f"{name} {err_rel:.3e} (own {extra / scale:.3e})")
    log(f"{label}: {len(names)} tensors, largest difference {worst:.3e} of its tensor's scale (gate {rel}"
        f"{'' if own is None else ' plus the reference own distance from float64'}); beyond {rel}: "
        f"{beyond or 'none'}")
    return worst


def run_bf16_encoder() -> dict:
    """(i1): bench_transformer's bfloat16 row at full width."""
    t0 = time.perf_counter()
    step, params = build_bf16_step("cuda")
    log(f"(i1) bf16 train step compile (graph + grad + rewrites + link): {time.perf_counter() - t0:.2f} s; "
        f"graph {op_census(step)}")
    k1_err, k1_rel, k1_times, ops = phase_k1(step, np.random.default_rng(16))
    reset_peak()
    losses, launches, per_call = counted_steps(step, "(i1) bf16 train")
    if not all(v < losses[0] for v in losses[1:]):
        raise AssertionError(f"(i1): loss not below the first step's: {losses}")
    t = time_steps(step, N_TIMED_STEPS, "(i1) bf16 train step")
    require_captured(step, "(i1) bf16 train step")
    log(f"(i1) bf16 train step: {BATCH * SEQ / t['ms'] * 1e3:.1f} tokens/s ({BATCH}x{SEQ} tokens a step); "
        f"host time of one call {t['host']:.3f} ms; busy {t['busy']:.3f} of {t['wall']:.3f} ms; peak "
        f"{t['peak']:.3f} GiB, reserved {t['reserved']:.3f} GiB")
    del step, params
    release()
    step, params, grads = build_bf16_step("cuda", batch=1, with_grads=True)
    g = grads()
    loss = float(step())
    ref = cpu_reference("bf16")
    names = [name for name, _ in ref["params"]]
    compare_bf16("(i1) bf16 gradients at batch 1, card vs CPU", g, ref["grads"],
                 ["loss"] + [f"d{name}" for name in names], own=ref["own"])
    compare_bf16("(i1) bf16 step at batch 1, card vs CPU", [loss] + [p.value for p in params],
                 [ref["loss"]] + [torch.from_numpy(v) for _, v in ref["params"]], ["loss"] + names)
    del step, params, grads, g
    release()
    return {"k1_err": k1_err, "k1_rel": k1_rel, "k1_times": k1_times, "ops": ops, "launches": launches, "t": t}


def run_scale_arm(use_remat: bool, seen_ops=frozenset()) -> dict:
    """One arm of (i2), ``run_model_scale`` at SCALE_LAYERS layers with
    ``use_remat``: K1 on its Composites (but those in ``seen_ops``), its
    gradients at the start, 3 counted steps, N_SCALE_TIMED timed and one
    more for the falling loss; the Composite ops checked under "ops"."""
    label = f"(i2) {SCALE_LAYERS}L d={SCALE_D} ff={SCALE_FF} bf16 remat={use_remat}"
    t0 = time.perf_counter()
    step, params, grads = build_bf16_step("cuda", SCALE_LAYERS, SCALE_D, SCALE_HEADS, SCALE_FF, SCALE_BATCH,
                                          SCALE_SEQ, use_remat=use_remat, with_grads=True)
    n_params = sum(p.value.numel() for p in params)
    log(f"{label}: {n_params} parameters; compile of the step and of its gradients (graph + grad + rewrites "
        f"+ link) {time.perf_counter() - t0:.2f} s; graph {op_census(step)}")
    # the gradients at the seeds' start: an sgd step at lr 0.01 leaves
    # most bfloat16 weights as they were (lr x grad under half an ulp),
    # so the parameters alone would not show a wrong gradient
    first = [g.cpu() for g in grads()]
    del grads
    release()
    k1_err, k1_rel, _, ops = phase_k1(step, np.random.default_rng(17), skip=seen_ops, timed_shape=None,
                                      full=(SCALE_BATCH, SCALE_SEQ, SCALE_D))
    seen_ops = seen_ops | ops
    reset_peak()
    before = [p.value.cpu() for p in params]
    losses, launches, per_call = counted_steps(step, label)
    # compared by their bits, a tensor at a time on the card (a CPU pass
    # over 604 M bfloat16 values takes seconds)
    moved = sum(int((p.value.view(torch.int16) != b.to(p.value.device).view(torch.int16)).sum())
                for p, b in zip(params, before))
    after = [p.value.cpu() for p in params]
    del before
    log(f"{label}: {moved} of {n_params} parameter entries ({moved / n_params:.4%}) changed in the "
        f"{N_TRAIN_STEPS} steps")
    t = time_steps(step, N_SCALE_TIMED, label)
    require_captured(step, label)
    final_loss = float(step())   # after the counted and timed steps ((l4)'s falling loss)
    tok_s = SCALE_BATCH * SCALE_SEQ / t["ms"] * 1e3
    log(f"{label}: {t['ms']:.3f} ms a step, {tok_s:.1f} tokens/s; peak {t['peak']:.3f} GiB, reserved "
        f"{t['reserved']:.3f} GiB; host time of one call {t['host']:.3f} ms; busy {t['busy']:.3f} of "
        f"{t['wall']:.3f} ms")
    names = [p.name for p in params]
    del step, params
    release()
    return {"losses": losses, "after": after, "grads": first, "t": t, "launches": launches, "k1_err": k1_err,
            "k1_rel": k1_rel, "names": names, "tok_s": tok_s, "final_loss": final_loss, "per_call": per_call,
            "ops": seen_ops}


def run_model_scale_remat(seen_ops) -> dict:
    """(i2): ``run_model_scale_remat``, remat off then on, in one process."""
    arms = {}
    for use_remat in (False, True):
        arms[use_remat] = run_scale_arm(use_remat, seen_ops)
        seen_ops = arms[use_remat].pop("ops")
    plain, rem = arms[False], arms[True]
    names = [f"loss {i}" for i in range(N_TRAIN_STEPS)] + ["first loss"] + [f"d{n}" for n in plain["names"]] + \
        plain["names"]
    tensors = [[torch.tensor(v) for v in arm["losses"]] + arm["grads"] + arm["after"] for arm in (plain, rem)]
    differ = [n for n, a, b in zip(names, *tensors) if not torch.equal(_bits(a), _bits(b))]
    same = not differ
    n_grads = len(plain["grads"]) - 1
    if same:
        log(f"(i2) remat off and on: the {N_TRAIN_STEPS} losses, the loss and all {n_grads} gradients at the start, "
            f"and all {len(plain['after'])} parameters after the {N_TRAIN_STEPS} steps bitwise equal")
    else:
        log(f"(i2) remat off and on: not bitwise equal ({len(differ)} of {len(names)} tensors differ: "
            f"{differ[:12]})")
        compare_bf16("(i2) remat on against off", tensors[1], tensors[0], names)
    if not rem["t"]["peak"] < plain["t"]["peak"]:
        raise AssertionError(f"(i2): remat peak {rem['t']['peak']:.3f} GiB not below {plain['t']['peak']:.3f}")
    log(f"(i2) peak device memory remat off {plain['t']['peak']:.3f} GiB, on {rem['t']['peak']:.3f} GiB; step "
        f"{plain['t']['ms']:.3f} / {rem['t']['ms']:.3f} ms ({rem['t']['ms'] / plain['t']['ms']:.3f}x)")
    for arm in arms.values():
        del arm["after"], arm["grads"]
    return {"arms": arms, "same": same, "ops": seen_ops}


def _bits(t):
    """A tensor's bits as integers: compared bit for bit, and a CPU pass
    over bfloat16 values is several times slower than over int16 ones."""
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def build_lm_train(device: str, use_graph=None):
    """``examples/production_training.py``'s program at (g)'s width:
    ``DecoderLM(32000, 4, 512, 8, 2048, seed=0)``, AdamW (weight decay
    0.01) under ``warmup_cosine(lr_max=3e-3, warmup_steps=20,
    total_steps=200)`` on a shared step counter, inside
    ``scaled_loss_updates``: (model, updates, compiled step)."""
    import aesara_tpu_torch as ptp
    import aesara_tpu_torch.tensor as pt
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models.optim import adamw_from_grads, scaled_loss_updates, warmup_cosine

    lm = build_decoder(device)
    with config.change_flags(device=device, floatX="float32"):
        toks = pt.lvector("toks")
        loss = lm.loss(toks)
        step_ctr = ptp.shared(np.float32(0.0), name="step")
        lr = warmup_cosine(step_ctr, lr_max=TRAIN_LR_MAX, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_TOTAL)
        updates = scaled_loss_updates(loss, lm.params, lambda grads: adamw_from_grads(
            lm.params, grads, lr=lr, weight_decay=TRAIN_WD))
        updates.append((step_ctr, step_ctr + 1.0))
        train = ptp.function([toks], ptp.Out(loss, borrow=True), updates=updates,
                             mode=ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph)))
    return lm, updates, train


def train_rows() -> np.ndarray:
    return np.random.default_rng(0).integers(0, DEC_VOCAB, size=(TRAIN_ROWS, TRAIN_ROW_LEN)).astype("int64")


def lm_train_cpu_reference() -> dict:
    """(i3)'s CPU twin, made in ``cpu_reference``'s process: TRAIN_CPU_STEPS
    steps of the program from the seeds on the first rows; their losses and
    every state variable after the first."""
    from aesara_tpu_torch.models.checkpoint import state_shareds

    t0 = time.perf_counter()
    lm, updates, train = build_lm_train("cpu")
    rows = train_rows()
    losses = [float(train(rows[0]))]
    state = [(v.name, v.value.double().numpy()) for v in state_shareds(lm.params, updates)]
    losses += [float(train(row)) for row in rows[1:TRAIN_CPU_STEPS]]
    return {"losses": losses, "state": state, "seconds": time.perf_counter() - t0}


def run_lm_train() -> dict:
    """(i3): the example's program at (g)'s width on the card."""
    import tempfile

    from aesara_tpu_torch.models.checkpoint import load_checkpoint, save_checkpoint, state_shareds

    t0 = time.perf_counter()
    lm, updates, train = build_lm_train("cuda")
    log(f"(i3) DecoderLM({DEC_VOCAB}, {DEC_LAYERS}, {DEC_D}, {DEC_HEADS}, {DEC_FF}) train step compile: "
        f"{time.perf_counter() - t0:.2f} s; {len(composite_nodes(train))} Composites")
    rows = train_rows()
    t0 = time.perf_counter()
    shapes = composite_shapes(train, [torch.as_tensor(rows[0], device="cuda")])
    k1_rows = check_composites(list(shapes), "(i3)", np.random.default_rng(18), shapes=shapes, time_each=False)
    k1_err = max(row["max_abs_err"] for row in k1_rows)
    log(f"(i3) K1 on {len(k1_rows)} distinct Composites of {len(shapes)} at the call's shapes: max_abs_err "
        f"{k1_err:.3e} (tolerance {F32_ATOL}), {time.perf_counter() - t0:.2f} s")
    per_call = graph_launches(train)
    state = state_shareds(lm.params, updates)
    zero_counters()
    losses = [float(train(rows[0]))]
    first_state = [SimpleNamespace(name=v.name, value=v.value.clone()) for v in state]
    ref = cpu_reference("lm_train")
    compare_state("(i3) first step", first_state,
                  [SimpleNamespace(name=n, value=torch.from_numpy(v)) for n, v in ref["state"]], TRAIN_TOL)
    del first_state
    workdir = tempfile.TemporaryDirectory()
    path = f"{workdir.name}/ckpt.npz"
    steps_s = 0.0
    for epoch in range(TRAIN_EPOCHS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for row in rows[1:] if epoch == 0 else rows:
            losses.append(float(train(row)))
        steps_s += time.perf_counter() - t0
        save_checkpoint(path, lm.params, updates, extra={"epoch": np.int64(epoch)})
    ms = steps_s * 1e3 / (len(losses) - 1)
    launches = read_counters(per_call, "(i3) train", len(losses))
    epochs = [float(np.mean(losses[k * TRAIN_ROWS:(k + 1) * TRAIN_ROWS])) for k in range(TRAIN_EPOCHS)]
    log(f"(i3) {len(losses)} steps of {TRAIN_ROW_LEN - 1} tokens: {ms:.3f} ms a step, each reading its loss on "
        f"the host ({(TRAIN_ROW_LEN - 1) / ms * 1e3:.1f} tokens/s); mean loss by epoch {epochs} (the JAX package "
        f"on the CPU: 10.606, 13.540, tests/test_torch_production_training.py); losses "
        f"{[round(v, 4) for v in losses]}")
    # the first step at TRAIN_TOL, then the losses the CPU gives (the
    # schedule overshoots at this width, in the JAX package too: they rise)
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    log(f"(i3) losses of the first {len(errs)} steps, card vs CPU: {[round(v, 6) for v in ref['losses']]}, "
        f"largest relative difference {max(errs):.3e} (first step {errs[0]:.3e}, tolerance {TRAIN_TOL}; later "
        f"{TRAIN_LOSS_REL})")
    if not (all(np.isfinite(losses)) and errs[0] <= TRAIN_TOL and max(errs) <= TRAIN_LOSS_REL):
        raise AssertionError(f"(i3): losses {losses[:len(errs)]} against the CPU's {ref['losses']}")
    require_captured(train, "(i3) train step")
    t0 = time.perf_counter()
    lm2, updates2, train2 = build_lm_train("cuda")
    extra = load_checkpoint(path, lm2.params, updates2)
    state2 = state_shareds(lm2.params, updates2)
    if int(extra["epoch"]) != TRAIN_EPOCHS - 1 or not all(
            a.value.dtype == b.value.dtype and torch.equal(a.value, b.value) for a, b in zip(state, state2)):
        raise AssertionError("(i3): the resumed state is not the saved one bit for bit")
    log(f"(i3) resumed into a fresh graph ({time.perf_counter() - t0:.2f} s): all {len(state2)} state variables "
        f"bitwise the saved ones, epoch {int(extra['epoch'])}")
    tokens = _host(lm2.generate_fn(GEN_STEPS, GEN_T_MAX, mode=decoder_mode())(np.int64(1)))
    cpu = build_decoder("cpu")
    load_checkpoint(path, cpu.params, strict=False)
    want = _host(cpu.generate_fn(GEN_STEPS, GEN_T_MAX, mode=decoder_mode(device="cpu"))(np.int64(1)))
    log(f"(i3) {GEN_STEPS} tokens of the resumed model: card {tokens.tolist()}, CPU {want.tolist()}")
    if tokens.tolist() != want.tolist():
        raise AssertionError("(i3): the resumed model's tokens are not the CPU's from the same checkpoint")
    workdir.cleanup()
    a, b = float(train(rows[0])), float(train2(rows[0]))
    if a != b or not all(torch.equal(x.value, y.value) for x, y in zip(state, state2)):
        raise AssertionError(f"(i3): one more step from the saved and the resumed graph differs ({a}, {b})")
    log(f"(i3) one more step from the trained and the resumed graph: loss {a} both, every state variable "
        f"bitwise equal")
    del lm, lm2, train, train2, state, state2, cpu
    release()
    return {"k1_err": k1_err, "launches": launches, "ms": ms, "losses": losses}


def run_recording(fn, args, pick, keep) -> dict:
    """{node: ``keep(its inputs)``} for the nodes ``pick`` selects, of one
    run of a compiled function's program on ``args`` (its user inputs on
    the card), read by wrapping those nodes' lowerings for that run; the
    program runs as ``Program.run`` runs it, and no update is written."""
    program, seen = fn.fn.program, {}

    def recording(node, lowered):
        def run(*ins, **kwargs):
            seen[node] = keep(ins)
            return lowered(*ins, **kwargs)
        return run

    lowered = program.fns
    program.fns = [recording(node, f) if pick(node) else f for node, f in zip(program.order, lowered)]
    try:
        program.run(list(args) + [v.value for v in fn.fn.shared_inputs], {})
    finally:
        program.fns = lowered
    return seen


def composite_shapes(fn, args) -> dict:
    """{Composite node: its inputs' shapes} of one run (``run_recording``)."""
    from aesara_tpu_torch.scalar.composite import Composite

    return run_recording(fn, args, lambda node: isinstance(getattr(node.op, "scalar_op", None), Composite),
                         lambda ins: [tuple(a.shape) for a in ins])


def check_lm_softmax() -> dict:
    """K4 at (i3)'s causal attention softmax, (heads 8, 256, 256) in
    float64 as the graph computes it, against its plain version and
    ``torch.softmax``."""
    x = torch.randn((DEC_HEADS * (TRAIN_ROW_LEN - 1), TRAIN_ROW_LEN - 1), device="cuda", dtype=torch.float64,
                    generator=torch.Generator(device="cuda").manual_seed(19))
    mask = torch.triu(torch.ones(x.shape[1], x.shape[1], dtype=torch.bool, device="cuda"), 1)
    x = x.view(DEC_HEADS, TRAIN_ROW_LEN - 1, -1).masked_fill(mask, -1e9).view_as(x)
    return check_k4(x, log_softmax=False)


def bf16_attention_checks() -> dict:
    """K2 and K3 in bfloat16 at path (i)'s panels (``check_attention``).
    The main run makes them early, with the other kernel checks: late in
    the run the profiler has read kernels faster than their bound."""
    t0 = time.perf_counter()
    out = {shape: check_attention(shape) for shape in BF16_PANELS}
    log(f"(i) K2/K3 bf16 checks: {time.perf_counter() - t0:.2f} s")
    return out


def phase_bf16(attention=None) -> dict:
    """Path (i): (i1), the K2/K3 checks at (i)'s panels (unless made before,
    ``attention``), (i2), (i3)."""
    matmul = torch.backends.cuda.matmul
    log(f"(i) reduced-precision reductions: bf16 {matmul.allow_bf16_reduced_precision_reduction}, "
        f"fp16 {matmul.allow_fp16_reduced_precision_reduction} (both must be off)")
    out = {}
    t0 = time.perf_counter()
    out["i1"] = run_bf16_encoder()
    log(f"(i1) path: {time.perf_counter() - t0:.2f} s")
    out["attention"] = attention if attention is not None else bf16_attention_checks()
    t0 = time.perf_counter()
    out["i2"] = run_model_scale_remat(out["i1"]["ops"])
    log(f"(i2) path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    out["i3"] = run_lm_train()
    out["k4"] = check_lm_softmax()
    log(f"(i3) path: {time.perf_counter() - t0:.2f} s")
    return out


def bf16_only():
    """--bf16: the setup and path (i) alone."""
    phase_setup()
    start_cpu_references("bf16", "lm_train")
    phase_bf16()
    stop_cpu_references()
    log("chip_smoke --bf16: path (i) passed")


# ---------------------------------------------------------------------------
# path (j): the conv net at LeNet's widths trained and served, and control flow
# ---------------------------------------------------------------------------

def set_cudnn_for_convolutions():
    """cuDNN in full fp32 (as the JAX package convolves), deterministic (so
    a captured step equals its eager run bitwise) and without autotuning
    (which a capture must not run): the linker refuses the first and the
    last otherwise."""
    cudnn = torch.backends.cudnn
    cudnn.allow_tf32 = False
    cudnn.deterministic = True
    cudnn.benchmark = False
    conv = getattr(cudnn, "conv", None)
    precision = (f", conv.fp32_precision {conv.fp32_precision}" if conv is not None and hasattr(conv, "fp32_precision")
                 else "")
    log(f"(j) cuDNN {cudnn.version()}: allow_tf32 {cudnn.allow_tf32}{precision}, deterministic "
        f"{cudnn.deterministic}, benchmark {cudnn.benchmark}")


def conv_images(n: int, seed: int):
    """``n`` synthetic 28 x 28 single-channel images (float32) and labels,
    from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 1) + CONV_HW).astype("float32"),
            rng.integers(0, CONV_CLASSES, size=n).astype("int64"))


def build_convnet(device: str, use_graph=None, fns=("step", "grads", "predict", "logits")) -> dict:
    """``ConvNet(1, (28, 28), [20, 50], 10, seed=0)`` in float32, compiled
    on ``device``: those of ``fns`` among ``step`` (sgd at CONV_LR, the loss
    returned borrowed), ``grads`` (the loss and every parameter's
    gradient), ``predict`` and ``logits``; with the model's ``params``, the
    symbolic ``x``, ``y``, ``loss`` and sgd ``updates``, and the ``mode``."""
    import aesara_tpu_torch as ptp
    import aesara_tpu_torch.tensor as pt
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models import ConvNet, sgd

    mode = ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph))
    with config.change_flags(device=device, floatX="float32"):
        model = ConvNet(1, CONV_HW, CONV_CHANNELS, CONV_CLASSES, seed=0)
    x, y = pt.tensor4("x", dtype="float32"), pt.lvector("y")
    loss = model.loss(x, y)
    updates = sgd(loss, model.params, lr=CONV_LR)
    make = {"step": lambda: ptp.function([x, y], ptp.Out(loss, borrow=True), updates=updates, mode=mode),
            "grads": lambda: ptp.function([x, y], [loss] + ptp.grad(loss, model.params), mode=mode),
            "predict": lambda: ptp.function([x], model.predict(x), mode=mode),
            "logits": lambda: ptp.function([x], model.logits(x), mode=mode)}
    return dict({k: make[k]() for k in fns}, params=model.params, x=x, y=y, loss=loss, updates=updates, mode=mode)


#: the ops of path (j) that run library calls, not kernels of the port
CONV_POOL_OPS = ("AbstractConv2d", "AbstractConv2dGradWeights", "AbstractConv2dGradInputs", "Pool", "PoolGrad")


def conv_census(fn) -> dict:
    """Nodes of a compiled step by op: the convolutions, pools and their
    gradients, and the Composites (one K1 launch each)."""
    names = [type(n.op).__name__ for n in fn.fn.program.order]
    census = {k: names.count(k) for k in CONV_POOL_OPS}
    census["Composite"] = len(composite_nodes(fn))
    return census


def conv_pool_ms(fn, args) -> dict:
    """Device ms of each convolution and pool node of one call of ``fn``
    (its lowering run alone on the inputs a run gave it, by the profiler),
    summed by op."""
    program = fn.fn.program
    inputs = run_recording(fn, args, lambda node: type(node.op).__name__ in CONV_POOL_OPS, list)
    by_op = dict.fromkeys(CONV_POOL_OPS, 0.0)
    for node, ins in inputs.items():
        lowered = program.fns[program.order.index(node)]
        by_op[type(node.op).__name__] += device_ms(lambda: lowered(*ins), reps=10)
    return by_op


def check_convnet_against_cpu(label: str):
    """One step's loss and every parameter's gradient at batch
    CONV_CPU_BATCH, card against CPU from the same seeded weights, within
    TRAIN_TOL."""
    x, y = conv_images(CONV_CPU_BATCH, SEED + 7)
    got = [_host(v) for v in build_convnet("cuda", fns=("grads",))["grads"](x, y)]
    want = [_host(v) for v in build_convnet("cpu", fns=("grads",))["grads"](x, y)]
    err = 0.0
    for g, w in zip(got, want):
        err = max(err, float(np.abs(g.astype("float64") - w.astype("float64")).max()))
        np.testing.assert_allclose(g, w, atol=TRAIN_TOL, rtol=TRAIN_TOL)
    log(f"{label}: one step at batch {CONV_CPU_BATCH}, card vs CPU, the loss and {len(got) - 1} gradients: max abs "
        f"err {err:.3e} (tolerance {TRAIN_TOL}, relative and absolute)")
    return err


def check_conv_predict(built, label: str) -> dict:
    """CONV_REQUESTS ``predict`` requests of CONV_BATCH new images and one of
    a single image, each against the CPU's labels from the card's trained
    weights: equal, but where the CPU's top-2 logit gap is under TIE_REL
    of that row's logits' scale (the tie rule)."""
    cpu = build_convnet("cpu", fns=("predict", "logits"))
    set_params(cpu["params"], [p.get_value() for p in built["params"]])
    predict, ties, times = built["predict"], 0, []
    sizes = [CONV_BATCH] * CONV_REQUESTS + [1]
    for i, n in enumerate(sizes):
        x, _ = conv_images(n, SEED + 100 + i)
        t0 = time.perf_counter()
        got = predict(x)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        got = _host(got)
        want = _host(cpu["predict"](x))
        if got.shape != (n,) or got.dtype != np.int64:
            raise AssertionError(f"{label} predict: {got.dtype} {got.shape}")
        for row in np.flatnonzero(got != want):
            logits = _host(cpu["logits"](x[row:row + 1]))[0].astype("float64")
            top = np.sort(logits)[-2:]
            gap, scale = float(top[1] - top[0]), float(np.abs(logits).max())
            log(f"{label} predict request {i}: image {row} labelled {got[row]} against the CPU's {want[row]}; the "
                f"CPU's top-2 gap {gap / scale:.3e} of the scale (tie rule: under {TIE_REL})")
            if not gap < TIE_REL * scale:
                raise AssertionError(f"{label} predict request {i}: image {row} differs and is no tie")
            ties += 1
    if predict.fn.capture_blocker is not None:
        raise AssertionError(f"{label} predict: capture blocked by {predict.fn.capture_blocker}")
    log(f"{label}: predict requests of {sizes} images agree with the CPU ({ties} ties); ms a request "
        f"{[round(t, 3) for t in times]} (the first of each size runs eagerly, the second captures); "
        f"last call {'replayed' if predict.captured else 'ran eagerly'}")
    return {"ties": ties, "request_ms": times}


def run_convnet() -> dict:
    """(j1): the graph, K1 and K4 at its shapes, 3 counted steps, 10 timed
    and 3 profiled, the loss falling over the 13, the conv and pool device
    time, the card against the CPU, ``predict``, and its capture table
    line."""
    label = "(j1) ConvNet"
    t0 = time.perf_counter()
    built = build_convnet("cuda", fns=("step", "grads", "predict"))
    step = built["step"]
    log(f"{label}: compile (graph + grad + rewrites + link): {time.perf_counter() - t0:.2f} s")
    x, y = conv_images(CONV_BATCH, SEED)
    xc, yc = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    per_call = graph_launches(step)
    census = conv_census(step)
    log(f"{label} step graph: {census}; launches a step {per_call}")
    if min(census.values()) < 1 or per_call["K4"] != 1:
        raise AssertionError(f"{label}: the step's graph lacks a convolution, pool or K4 op: {census}")
    rows = check_composites(composite_nodes(step), label, np.random.default_rng(41),
                            shapes=composite_shapes(step, (xc, yc)), time_each=False)
    k4 = check_k4(torch.randn((CONV_BATCH, CONV_CLASSES), device="cuda",
                              generator=torch.Generator(device="cuda").manual_seed(42)) * 3)
    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    losses = []
    for _ in range(N_CONV_STEPS):
        loss = step(xc, yc)
        if not (loss.is_cuda and loss.shape == () and loss.dtype == torch.float32):
            raise AssertionError(f"{label}: loss {loss} is not a float32 scalar on the card")
        losses.append(float(loss))
    torch.cuda.synchronize()
    launches = read_counters(per_call, label, N_CONV_STEPS)
    t = time_steps(lambda: step(xc, yc), N_CONV_TIMED, f"{label} train step")
    require_captured(step, f"{label} train step")
    if step.capture_blocker is not None:
        raise AssertionError(f"{label}: capture blocked by {step.capture_blocker}")
    after = float(_host(built["grads"](xc, yc)[0]))
    log(f"{label} losses: {losses} in the counted steps, {after:.6f} after all {N_CONV_STEPS + N_CONV_TIMED} "
        "steps and the profiled ones")
    if not (all(np.isfinite(losses)) and np.isfinite(after) and after < losses[0]):
        raise AssertionError(f"{label}: the loss did not fall: {losses[0]} -> {after}")
    by_op = conv_pool_ms(step, (xc, yc))
    conv_pool = sum(by_op.values())
    busy = t["busy"]
    log(f"{label} train step: {t['ms']:.3f} ms a step back to back, {CONV_BATCH / t['ms'] * 1e3:.1f} images/s, host "
        f"{t['host']:.3f} ms a call, device busy {busy:.3f} of {t['wall']:.3f} ms, peak {t['peak']:.3f} GiB; "
        f"convolutions and pools alone {conv_pool:.3f} ms a step ({100 * conv_pool / busy:.1f}% of the busy time: "
        + ", ".join(f"{k} {v:.3f}" for k, v in by_op.items()) + ")")
    cpu_err = check_convnet_against_cpu(label)
    serve = check_conv_predict(built, label)
    def captured_or_eager(use_graph):
        b = build_convnet("cuda", use_graph, fns=("step",))
        return b["step"], lambda: b["step"](xc, yc), b["params"]

    row = capture_row("(j1) ConvNet train step (sgd)", captured_or_eager)
    if not row[1]:
        raise AssertionError("(j1): the captured step is not bitwise equal to the eager one")
    return dict(t, built=built, data=(xc, yc), launches=launches, composites=rows, k4=k4, census=census,
                per_call=per_call, losses=losses + [after], conv_pool=by_op, cpu_err=cpu_err, serve=serve)


def run_control_flow(j1: dict) -> dict:
    """(j2) on (j1)'s model and batch: the guarded step, a shape Assert and
    a function holding a Print."""
    import aesara_tpu_torch as ptp
    import aesara_tpu_torch.tensor as pt
    from aesara_tpu_torch.ifelse import ifelse
    from aesara_tpu_torch.printing import Print
    from aesara_tpu_torch.raise_op import Assert
    from aesara_tpu_torch.tensor import math as tm

    label = "(j2)"
    built, (xc, yc) = j1["built"], j1["data"]
    x, y, loss, params, mode = built["x"], built["y"], built["loss"], built["params"], built["mode"]
    finite = tm.invert(tm.or_(tm.isnan(loss), tm.isinf(loss)))
    guarded = ptp.function([x, y], ptp.Out(loss, borrow=True), mode=mode,
                           updates=[(p, ifelse(finite, new, p)) for p, new in built["updates"]])
    n_if = sum(type(n.op).__name__ == "IfElse" for n in guarded.fn.program.order)
    start = [p.get_value() for p in params]
    for call in range(3):
        runs = []
        for fn in (built["step"], guarded):
            set_params(params, start)
            runs.append([_host(fn(xc, yc))] + [_host(p.value) for p in params])
        _, _, same = _difference(*runs)
        if not same:
            raise AssertionError(f"{label} guarded step call {call}: not bitwise equal to (j1)'s sgd step")
    require_captured(guarded, f"{label} guarded step")
    bad = xc.clone()
    bad[3, 0, 5, 7] = float("nan")
    before = [p.value.clone() for p in params]
    nan_loss = float(guarded(bad, yc))
    if not np.isnan(nan_loss) or not guarded.captured:
        raise AssertionError(f"{label} guarded step on a NaN pixel: loss {nan_loss}, captured {guarded.captured}")
    for p, b in zip(params, before):
        if not torch.equal(p.value, b):
            raise AssertionError(f"{label} guarded step on a NaN pixel changed {p.name}")
    log(f"{label} guarded step ({n_if} IfElse, one a parameter): 3 calls (eager, captured, replayed) bitwise equal "
        f"to (j1)'s sgd step from the same weights; on a batch with one NaN pixel, replayed, the loss {nan_loss} and "
        "every parameter kept its bits")
    message = "(j2): the labels must number the images"
    checked = ptp.function([x, y], Assert(message)(loss, pt.eq(x.shape[0], y.shape[0])), mode=mode)
    for _ in range(3):
        ok = float(checked(xc, yc))
    require_captured(checked, f"{label} shape Assert")
    try:
        checked(xc, yc[:-1])
    except AssertionError as exc:
        if str(exc) != message:
            raise AssertionError(f"{label} shape Assert raised {exc!r}, not its message") from exc
        log(f"{label} shape Assert: passes on {CONV_BATCH} images and labels (loss {ok:.6f}, captured), raises "
            f"AssertionError({str(exc)!r}) on {CONV_BATCH - 1} labels")
    else:
        raise AssertionError(f"{label} shape Assert: no error on {CONV_BATCH - 1} labels")
    printed = ptp.function([x, y], Print("(j2) loss")(loss), mode=mode)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        for _ in range(2):
            printed(xc, yc)
    lines = out.getvalue().splitlines()
    blocker = printed.fn.capture_blocker
    if len(lines) != 2 or not all(ln.startswith("(j2) loss ") for ln in lines) or printed.captured \
            or "Print" not in (blocker or ""):
        raise AssertionError(f"{label} Print: lines {lines}, captured {printed.captured}, blocker {blocker}")
    log(f"{label} Print: 2 calls printed {lines}; eager, capture blocker: {blocker}")
    return {"ifelse": n_if, "nan_loss": nan_loss}


def phase_convnet() -> dict:
    """Path (j): (j1) and (j2) (see the module docstring)."""
    set_cudnn_for_convolutions()
    t0 = time.perf_counter()
    out = {"j1": run_convnet()}
    log(f"(j1) path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    out["j2"] = run_control_flow(out["j1"])
    log(f"(j2) path: {time.perf_counter() - t0:.2f} s")
    out["j1"].pop("built")
    out["j1"].pop("data")
    release()
    return out


def convnet_only():
    """--convnet: the setup and path (j) alone."""
    phase_setup()
    phase_convnet()
    log("chip_smoke --convnet: path (j) passed")


# ---------------------------------------------------------------------------
# path (k): the CTC loss at Deep Speech 2's output width, the distributions
# and MRG31k3p streams
# ---------------------------------------------------------------------------

def ctc_data(seed: int = SEED):
    """(k1)'s batch from ``default_rng(seed)``: features (T, B, D), labels
    of CTC_LLEN characters from 1..C-1 (0 is the blank), a share
    CTC_REPEAT of them repeating the one before, padded with -1 to L; input
    lengths in CTC_ILEN; the head's weights."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(CTC_T, CTC_B, CTC_D)).astype("float32")
    lens = rng.integers(CTC_LLEN[0], CTC_LLEN[1] + 1, size=CTC_B)
    labels = np.full((CTC_B, CTC_L), -1, dtype=np.int64)
    for b, n in enumerate(lens):
        row = rng.integers(1, CTC_C, size=n)
        repeat = rng.random(n) < CTC_REPEAT
        for j in range(1, n):
            if repeat[j]:
                row[j] = row[j - 1]
        labels[b, :n] = row
    ilen = rng.integers(CTC_ILEN[0], CTC_ILEN[1] + 1, size=CTC_B)
    w0 = (rng.normal(size=(CTC_D, CTC_C)) * 0.02).astype("float32")
    return x, labels, ilen, w0


def build_ctc(device: str, data, use_graph=None) -> dict:
    """(k1)'s functions on ``device``: the sgd step of the CTC head (x a
    shared tensor there, labels and input lengths arguments), returning
    the loss and both gradients before its update, and each utterance's
    loss."""
    import aesara_tpu_torch as ptp
    import aesara_tpu_torch.tensor as pt
    from aesara_tpu_torch.tensor.nnet.ctc import ctc

    x0, _, _, w0 = data
    mode = ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph))
    x = ptp.shared(x0, name="ctc_x", device=device)
    w = ptp.shared(w0.copy(), name="ctc_w", device=device)
    b = ptp.shared(np.zeros(CTC_C, "float32"), name="ctc_b", device=device)
    lab, il = pt.lmatrix("labels"), pt.lvector("input_lengths")
    per_utt = ctc(pt.dot(x, w) + b, lab, il)
    loss = pt.mean(per_utt)
    gw, gb = ptp.grad(loss, [w, b])
    step = ptp.function([lab, il], [loss, gw, gb], updates=[(w, w - CTC_LR * gw), (b, b - CTC_LR * gb)], mode=mode)
    losses = ptp.function([lab, il], per_utt, mode=mode)
    return {"step": step, "losses": losses, "params": (w, b)}


def _rel(got, want) -> float:
    """Largest difference over the largest magnitude of ``want``."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def ctc_cpu_reference() -> dict:
    """(k1)'s CPU twin, made in ``cpu_reference``'s process: the loss and
    both gradients of the first step, and each utterance's loss on the
    batch with an impossible alignment."""
    t0 = time.perf_counter()
    data = ctc_data()
    _, labels, ilen, _ = data
    cpu = build_ctc("cpu", data)
    grads = [np.asarray(v) for v in cpu["step"](labels, ilen)]
    losses = np.asarray(cpu["losses"](labels, ctc_impossible(ilen)))
    return {"grads": grads, "losses": losses, "seconds": time.perf_counter() - t0}


def ctc_impossible(ilen):
    """(k1)'s input lengths with utterance 0 cut under its label's length."""
    bad = ilen.copy()
    bad[0] = CTC_LLEN[0] // 2
    return bad


def run_ctc() -> dict:
    """(k1): K4 at the step's log-softmax; the loss and both gradients at
    full size and an impossible alignment's loss against the CPU; 3
    captured steps bitwise equal to 3 eager ones; step time, launches and
    device split of a captured step."""
    data = ctc_data()
    x, labels, ilen, w0 = data
    t0 = time.perf_counter()
    cap, eag = build_ctc("cuda", data), build_ctc("cuda", data, use_graph=False)
    log(f"(k1) CTC head compiled twice (captured, eager): {time.perf_counter() - t0:.2f} s")
    xt = torch.as_tensor(x, device="cuda")
    k4 = check_k4((xt.reshape(-1, CTC_D) @ torch.as_tensor(w0, device="cuda")).contiguous(), True)
    t0 = time.perf_counter()
    # an impossible alignment: input length under the label's
    bad = ctc_impossible(ilen)
    lc = cap["losses"](labels, bad).cpu().numpy()
    # 3 eager steps (the first's loss and gradients against the CPU's), then
    # 3 captured ones (counted: eager, capture, replay), bitwise the eager ones
    eager = []
    for _ in range(N_CTC_STEPS):
        out = eag["step"](labels, ilen)
        eager.append([v.clone() for v in out] + [p.value.clone() for p in eag["params"]])
    got = [v.cpu().numpy() for v in eager[0][:3]]
    log(f"(k1) the losses of the impossible batch and 3 eager steps: {time.perf_counter() - t0:.2f} s")
    cpu = cpu_reference("ctc")
    errs = {name: _rel(g, w) for name, g, w in zip(("loss", "grad_W", "grad_b"), got, cpu["grads"])}
    log(f"(k1) first step's loss {float(got[0]):.6f} (CPU {float(cpu['grads'][0]):.6f}); card against CPU, of each "
        f"largest value: {errs} (tolerance {CTC_TOL})")
    if not all(np.all(np.isfinite(g)) for g in got) or max(errs.values()) > CTC_TOL:
        raise AssertionError(f"(k1) the card's loss and gradients are not the CPU's: {errs}")
    lh = cpu["losses"]
    imp = _rel(lc, lh)
    log(f"(k1) impossible alignment (input 0: {bad[0]} frames, {int((labels[0] >= 0).sum())} labels): loss "
        f"{lc[0]:.6e} (CPU {lh[0]:.6e}), all finite {bool(np.all(np.isfinite(lc)))}, card against CPU {imp:.3e}")
    if not np.all(np.isfinite(lc)) or lc[0] < 1e29 or imp > CTC_TOL:
        raise AssertionError("(k1) the impossible alignment's loss is not the CPU's finite floor")
    zero_counters()
    t0 = time.perf_counter()
    for i, want in enumerate(eager):
        got = list(cap["step"](labels, ilen)) + [p.value for p in cap["params"]]
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        log(f"(k1) step {i + 1}: loss {float(got[0]):.6f}, captured bitwise the eager step: {same}")
        if not same:
            raise AssertionError(f"(k1) captured step {i + 1} differs from the eager one")
    del eager
    log(f"(k1) 3 captured calls (eager, capture, replay): {time.perf_counter() - t0:.2f} s")
    counters = _all_counters()
    launches = {k: c.launches for k, c in counters.items()}
    replayed = {k: c.replayed for k, c in counters.items()}
    plain = sum(c.plain_calls for c in counters.values())
    log(f"(k1) {N_CTC_STEPS} captured steps: launches {launches}, replayed {replayed}, plain calls {plain}")
    if plain or launches["K4"] == 0 or replayed["K4"] == 0:
        raise AssertionError("(k1) the step did not run K4 on the card in every call")
    require_captured(cap["step"], "(k1) CTC step")
    # step time, launches and the device split of a replay
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_CTC_TIMED):
        cap["step"](labels, ilen)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / N_CTC_TIMED * 1e3
    # one replay profiled: a step's trace holds about 110,000 kernels
    census: dict = {}
    t0 = time.perf_counter()
    split = device_split(lambda: cap["step"](labels, ilen), reps=1, warmup=0, census=census)
    log(f"(k1) one replay profiled: {time.perf_counter() - t0:.2f} s")
    groups: dict = {}
    for name, ms in split.items():
        groups[kernel_group(name)] = groups.get(kernel_group(name), 0.0) + ms
    n_kernels = census["events"]
    log(f"(k1) captured step: {step_ms:.3f} ms back to back ({N_CTC_TIMED} steps), {n_kernels} device kernels a "
        f"step, device ms by group {dict((k, round(v, 4)) for k, v in groups.items())} "
        f"(the DP's torch ops are 'other torch')")
    del cap, eag
    release()
    return {"k4": k4, "launches": launches, "replayed": replayed, "step_ms": step_ms, "kernels_a_step": n_kernels,
            "device_ms": groups, "errors": errs, "impossible_rel": imp}


def _resized(values, n: int = RAND_N, dtype="float64"):
    """``values`` repeated to ``n``: each branch's share of one draw."""
    return np.resize(np.asarray(values, dtype=dtype), n)


def random_specs(stats):
    """(k2)'s draws, each of RAND_N values: (label, build(stream, rb), the
    groups' scipy distributions, group j the flat elements i with i %
    groups == j (a parameter repeated to RAND_N, or a component); the
    string "vonmises" or None where ``check_other`` stands in)."""
    n = RAND_N
    gam = (0.05, 0.7, 1.0, 3.5, 250.0)
    lam = (0.0, 0.5, 9.99, 10.0, 37.0, 1e4)
    bn = ((5, 0.3), (40, 0.2), (1000, 0.5), (1e6, 0.01))
    ba, bb = (0.05, 2.0, 0.7, 4.0), (1.5, 0.08, 3.0, 4.0)
    p4 = np.array([0.1, 0.2, 0.3, 0.4])
    dir4 = np.array([0.05, 0.5, 1.0, 3.0])
    mean2, cov2 = np.array([1.0, -1.0]), np.array([[2.0, 0.3], [0.3, 0.5]])
    disc = lambda vals, p=None: stats.rv_discrete(values=(vals, np.full(len(vals), 1 / len(vals)) if p is None else p))  # noqa: E731
    return [
        ("gamma", lambda s, rb: s.gamma(_resized(gam), 2.0), [stats.gamma(a, scale=2.0) for a in gam]),
        ("gamma_f32", lambda s, rb: s.gamma(_resized(gam, dtype="float32"), np.float32(1.0), dtype="float32"),
         [stats.gamma(a) for a in gam]),
        ("beta", lambda s, rb: s.beta(_resized(ba), _resized(bb)), [stats.beta(a, b) for a, b in zip(ba, bb)]),
        ("dirichlet", lambda s, rb: s.dirichlet(dir4, size=(n // 4,)),
         [stats.beta(a, dir4.sum() - a) for a in dir4]),
        ("chisquare", lambda s, rb: s.chisquare(_resized((0.5, 3.0))), [stats.chi2(d) for d in (0.5, 3.0)]),
        ("t", lambda s, rb: s.t(10.0, 0.5, 2.0, size=(n,)), [stats.t(10.0, loc=0.5, scale=2.0)]),
        ("invgamma", lambda s, rb: s.invgamma(6.0, 2.0, size=(n,)), [stats.invgamma(6.0, scale=2.0)]),
        ("f", lambda s, rb: s.f(3.0, 20.0, size=(n,)), [stats.f(3.0, 20.0)]),
        ("gengamma", lambda s, rb: s.gengamma(2.0, 1.5, 0.7, size=(n,)),
         [stats.gengamma(2.0 / 1.5, 1.5, scale=0.7)]),
        ("poisson", lambda s, rb: s.poisson(_resized(lam)), [stats.poisson(v) for v in lam]),
        ("poisson_f32", lambda s, rb: s.poisson(_resized(lam, dtype="float32")), [stats.poisson(v) for v in lam]),
        ("binomial", lambda s, rb: s.binomial(_resized([c for c, _ in bn]), _resized([p for _, p in bn])),
         [stats.binom(c, p) for c, p in bn]),
        ("nbinom", lambda s, rb: s.negative_binomial(5.0, 0.3, size=(n,)), [stats.nbinom(5, 0.3)]),
        ("betabinom", lambda s, rb: s.betabinom(20, 2.0, 3.0, size=(n,)), [stats.betabinom(20, 2.0, 3.0)]),
        ("multinomial", lambda s, rb: s.multinomial(20, p4, size=(n // 4,)), [stats.binom(20, p) for p in p4]),
        ("pareto", lambda s, rb: s.pareto(10.0, size=(n,)), [stats.pareto(10.0)]),
        ("geometric", lambda s, rb: s.geometric(0.3, size=(n,)), [stats.geom(0.3)]),
        ("truncated_normal", lambda s, rb: s.truncated_normal(-1.0, 2.0, size=(n,)), [stats.truncnorm(-1.0, 2.0)]),
        ("vonmises", lambda s, rb: s.vonmises(0.5, 2.0, size=(n,)), "vonmises"),
        ("integers", lambda s, rb: s.integers(-3, 17, size=(n,)), [stats.randint(-3, 17)]),
        # scipy's randint overflows its variance at this span: the discrete uniform's, exactly
        ("randint", lambda s, rb: s.randint(0, 2**40, size=(n,)),
         [SimpleNamespace(stats=lambda moments: ((2**40 - 1) / 2, (2.0**80 - 1) / 12))]),
        ("categorical", lambda s, rb: s.categorical(p4, size=(n,)), [disc(np.arange(4), p4)]),
        ("choice", lambda s, rb: s.choice(np.arange(10) * 3, size=(n,)), [disc(np.arange(10) * 3)]),
        ("choice_scalar", lambda s, rb: s.choice(7, size=(n,)), [disc(np.arange(7))]),
        ("choice_p", lambda s, rb: s.choice(np.arange(4) * 5, size=(n,), p=p4), [disc(np.arange(4) * 5, p4)]),
        ("choice_noreplace", lambda s, rb: s.choice(np.arange(2 * n), size=(n,), replace=False), None),
        ("permutation", lambda s, rb: s.permutation(np.arange(n)), None),
        ("multivariate_normal", lambda s, rb: s.multivariate_normal(mean2, cov2, size=(n // 2,)),
         [stats.norm(m, np.sqrt(cov2[j, j])) for j, m in enumerate(mean2)]),
        ("rayleigh", lambda s, rb: s.rayleigh(2.0, size=(n,)), [stats.rayleigh(scale=2.0)]),
        ("wald", lambda s, rb: s.wald(1.5, 2.0, size=(n,)), [stats.invgauss(1.5 / 2.0, scale=2.0)]),
        ("triangular", lambda s, rb: s.triangular(-1.0, 0.5, 2.0, size=(n,)),
         [stats.triang(0.5, loc=-1.0, scale=3.0)]),
        ("truncexpon", lambda s, rb: s.truncexpon(2.0, 0.5, 1.5, size=(n,)),
         [stats.truncexpon(2.0, loc=0.5, scale=1.5)]),
        ("power", lambda s, rb: s.power(2.5, size=(n,)), [stats.powerlaw(2.5)]),
        ("zipf", lambda s, rb: s.gen(rb.zipf, 6.0, size=(n,)), [stats.zipf(6.0)]),
        ("hypergeometric", lambda s, rb: s.gen(rb.hypergeometric, 10, 5, 4, size=(n,)),
         [stats.hypergeom(15, 10, 4)]),
    ]


def build_random(device: str, specs, use_graph=None):
    """One RandomStream and one function drawing every spec of (k2)."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.tensor.random import basic as rb
    from aesara_tpu_torch.tensor.random.utils import RandomStream

    with config.change_flags(floatX="float64"):
        srng = RandomStream(seed=SEED + 18)
        outs = [build(srng, rb) for _, build, _ in specs]
        fn = ptp.function([], outs, mode=ptp.Mode(ptp.TorchLinker(device=device, use_graph=use_graph)))
    return fn, srng


def check_moments(label: str, value, groups) -> list:
    """Each group's (the draw's flat elements i with i % groups == j) sample
    mean and variance within MOMENT_SE standard errors of its
    distribution's; the variance's error from the sample's fourth central
    moment.  Returns the worst z of each group."""
    v = value.to(torch.float64).reshape(-1)
    worst = []
    for j, dist in enumerate(groups):
        col = v[j::len(groups)]
        n = col.numel()
        mu, var = (float(t) for t in dist.stats(moments="mv"))
        if not (np.isfinite(mu) and np.isfinite(var) and var >= 0):
            raise AssertionError(f"(k2) {label} group {j}: no finite mean and variance to hold the draw to")
        m = float(col.mean())
        c = col - m
        s2 = float((c * c).mean())
        if var == 0:
            if not bool((col == mu).all()):
                raise AssertionError(f"(k2) {label} group {j}: a degenerate distribution drew other values")
            worst.append(0.0)
            continue
        m4 = float((c ** 4).mean())
        z_mean = abs(m - mu) / np.sqrt(var / n)
        z_var = abs(s2 - var) / np.sqrt(max(m4 - s2 * s2, 1e-300) / n)
        worst.append(max(z_mean, z_var))
        if worst[-1] > MOMENT_SE:
            raise AssertionError(f"(k2) {label} group {j}: mean {m} (want {mu}), variance {s2} (want {var}): "
                                 f"z {z_mean:.2f}, {z_var:.2f} over {MOMENT_SE}")
    return worst


def check_other(label: str, value):
    """The draws whose check is not a moment: the shuffle is a permutation,
    the draw without replacement has no repeat and stays in its
    population, the von Mises mean resultant length is A(kappa)."""
    from scipy import special

    if label == "permutation":
        ok = torch.equal(torch.sort(value).values, torch.arange(RAND_N, device=value.device))
        return ok, 0.0
    if label == "choice_noreplace":
        ok = torch.unique(value).numel() == RAND_N and int(value.min()) >= 0 and int(value.max()) < 2 * RAND_N
        return ok, 0.0
    cos = torch.cos(value - 0.5)
    want = special.i1(2.0) / special.i0(2.0)
    z = abs(float(cos.mean()) - want) / np.sqrt(float(cos.var()) / cos.numel())
    return z <= MOMENT_SE and bool((value.abs() <= np.pi).all()), z


# path (k)'s parameters of the loop kernels, each cycled to RAND_N values
# (_resized: every warp mixes branches), and TP's and TB's uniform rows
LOOP_GAMMA = (0.05, 0.7, 1.0, 3.5, 250.0)
LOOP_LAM = (0.0, 0.5, 9.99, 10.0, 37.0, 1e4)
LOOP_COUNT, LOOP_PROB = (5, 40, 1000, 1e6, 30), (0.3, 0.2, 0.5, 0.01, 0.9)
UNIFORM_LAM, UNIFORM_BINOMIAL = 37.0, (1000.0, 0.5)


def tp_tb_rows() -> list:
    """TP's and TB's rows at RAND_N values: (kernel, label, the draw's
    arguments after the key, bytes read), path (k)'s cycled parameters
    first (the row each kernel's line reports), then uniform ones."""
    def full(value, dtype):
        return torch.full((RAND_N,), value, dtype=dtype, device="cuda")

    lam = torch.as_tensor(_resized(LOOP_LAM, dtype="float32"), device="cuda")
    cnt = torch.as_tensor(_resized(LOOP_COUNT), device="cuda")
    prb = torch.as_tensor(_resized(LOOP_PROB), device="cuda")
    un, up = UNIFORM_BINOMIAL
    rows = [("TP", "float32 lam", (lam,)),
            ("TP", f"float32 lam {UNIFORM_LAM:g} (uniform)", (full(UNIFORM_LAM, torch.float32),)),
            ("TB", "float64", (cnt, prb)), ("TB", "float32", (cnt.float(), prb.float())),
            ("TB", f"float64 ({un:g}, {up:g}) (uniform)", (full(un, torch.float64), full(up, torch.float64))),
            ("TB", f"float32 ({un:g}, {up:g}) (uniform)", (full(un, torch.float32), full(up, torch.float32)))]
    return [(name, label, args, sum(a.numel() * a.element_size() for a in args)) for name, label, args in rows]


def tp_tb_draw(name: str, key, args):
    """TP's or TB's draw of ``args`` through its wrapper; only the wrappers'
    plain signatures are used, so another checkout's kernels run here too."""
    from aesara_tpu_torch.link.torch.kernels import random_loops as rl

    return (rl.poisson_draw if name == "TP" else rl.binomial_draw)(key, *args)


def tp_tb_plain(name: str, key, args, work):
    from aesara_tpu_torch.link.torch.kernels import random_loops as rl

    return (rl.poisson_plain if name == "TP" else rl.binomial_plain)(key, *args, work)


def mismatches(got, want) -> int:
    """Elements of ``got`` (a tensor or a tuple of them) that differ from
    ``want``'s, nan equal to nan."""
    got, want = (g if isinstance(g, tuple) else (g,) for g in (got, want))
    return sum(int((~((a == b) | (a.isnan() & b.isnan()) if a.is_floating_point() else a == b)).sum())
               for a, b in zip(got, want))


def mrg_state(n_streams: int):
    """A seeded (n_streams, 6) int32 MRG31k3p state on the card."""
    return torch.as_tensor(np.random.default_rng(SEED).integers(1, 2**31 - 30000, size=(n_streams, 6)),
                           dtype=torch.int32, device="cuda")


def mrg_edge_states():
    """Every state whose components come from 0, 1, m2 - 1 and m1 - 1: 4**6
    streams on the card."""
    edges = np.array([0, 1, MRG_M2 - 1, MRG_M1 - 1])
    return torch.as_tensor(np.stack(np.meshgrid(*[edges] * 6, indexing="ij"), -1).reshape(-1, 6),
                           dtype=torch.int32, device="cuda")


LOOP_KERNEL_NAMES = ("round keys", "TP pass 0", "TP pass 1", "TB fp32 pass 0", "TB fp32 pass 1", "TB fp64 pass 0",
                     "TB fp64 pass 1", "TM fp32", "TM fp64")


def loop_kernel_info(lib, which=range(len(LOOP_KERNEL_NAMES))) -> str:
    """The loop kernels' registers, local bytes and resident blocks an SM
    (``random_loops_kernel_info``), one line; a kernel the checkout's
    library does not report (an older one's) says so."""
    import ctypes

    cells = []
    for k in which:
        info = (ctypes.c_int * 4)()
        err = lib.random_loops_kernel_info(k, info)
        regs, local, resident, threads = list(info)
        cells.append(f"{LOOP_KERNEL_NAMES[k]}: not reported (error {err})" if err else
                     f"{LOOP_KERNEL_NAMES[k]}: {regs} registers, {local} local bytes, {resident} blocks of {threads} "
                     "an SM")
    return "; ".join(cells)


def ptxas_report() -> list:
    """``nvcc -Xptxas -v`` of the checkout's ``random_loops.cu``, built into
    a temporary directory that is deleted: each TP, TB and round-keys
    entry's registers, spill stores and loads and stack bytes, a line each
    (the spills apart from the stack, which ``random_loops_kernel_info``
    reads as one)."""
    import tempfile

    from aesara_tpu_torch.link.torch.kernels.build import CSRC, NVCC_FLAGS, find_nvcc

    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", os.path.join(tmp, "v.so"),
                              os.path.join(CSRC, "random_loops.cu")], capture_output=True, text=True)
    if res.returncode != 0:
        return [f"nvcc -Xptxas -v failed: {res.stderr[-2000:]}"]
    entry, stack, lines = None, ("?", "?", "?"), []
    for text in (res.stdout + res.stderr).splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", text)
        if m:
            entry, stack = m.group(1), ("?", "?", "?")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", text)
        if m and entry:
            stack = m.groups()
        m = re.search(r"Used (\d+) registers", text)
        if m and entry and any(k in entry for k in ("tp_kernel", "tb_kernel", "round_keys")):
            lines.append(f"{entry}: {m.group(1)} registers, spill stores {stack[1]} B, loads {stack[2]} B, "
                         f"stack {stack[0]} B")
            entry = None
    return lines


def loop_kernel_checks() -> dict:
    """TG, TP, TB and TM against their plain versions on the card at
    RAND_N values on the same key and state, parameters reaching every
    branch, TP and TB also at uniform ones: mismatches counted (0
    required), with the kernels' and plain versions' device times (TG's and
    TM's at their first row, TP's and TB's at every row; plain at each
    kernel's first), the bounds (bytes moved, or the threefry hashes these
    inputs need at TF_HASH_OPS each, counted by the plain versions, at
    INT32_OPS), TP's and TB's registers, local bytes and resident blocks
    (``random_loops_kernel_info``), and PyTorch's own samplers of the same
    distributions (other bits) as a note."""
    from aesara_tpu_torch.link.torch.kernels import random_loops as rl
    from aesara_tpu_torch.tensor.random.op import prng_key

    key = torch.as_tensor(prng_key(SEED + 18)).cuda()
    dev = "cuda"
    gam = torch.as_tensor(_resized(LOOP_GAMMA), device=dev)
    state = mrg_state(MRG_STREAMS)
    cases = {
        "TG": [(label, kernel, plain, gam.numel() * a.element_size()) for label, kernel, plain, a in (
            ("float64", lambda: rl.gamma_draw(key, gam, False), lambda w: rl.gamma_plain(key, gam, False, w), gam),
            ("float64 log", lambda: rl.gamma_draw(key, gam, True), lambda w: rl.gamma_plain(key, gam, True, w), gam),
            ("float32", lambda: rl.gamma_draw(key, gam.float(), False),
             lambda w: rl.gamma_plain(key, gam.float(), False, w), gam.float()))],
        "TP": [], "TB": [],
        "TM": [(dt, lambda dt=dt: rl.mrg_draw(state, RAND_N, dt), lambda w, dt=dt: rl.mrg_plain(state, RAND_N, dt),
                state.numel() * 4) for dt in ("float32", "float64")],
    }
    # TM also at a user's few streams and at the edge states, its plain
    # version on the CPU (a host loop of RAND_N / streams steps)
    for label, st in ((f"float32, {MRG_FEW_STREAMS} streams", mrg_state(MRG_FEW_STREAMS)),
                      ("float32, edge states", mrg_edge_states())):
        cases["TM"].append((label, lambda st=st: rl.mrg_draw(st, RAND_N, "float32"),
                            lambda w, st=st: tuple(t.to(dev) for t in rl.mrg_plain(st.cpu(), RAND_N, "float32")),
                            st.numel() * 4))
    for name, label, args, read in tp_tb_rows():
        cases[name].append((label, lambda name=name, args=args: tp_tb_draw(name, key, args),
                            lambda w, name=name, args=args: tp_tb_plain(name, key, args, w), read))
    res = {}
    for name, rows in cases.items():
        out = {"max_abs_err": 0.0, "mismatches": 0, "rows": {}}
        for label, kernel, plain, read in rows:
            work: dict = {}
            kept = []

            def run_plain():
                work.clear()
                kept.append(plain(work))

            got = kernel()
            # the plain version (a host test each round): its one call is the
            # check and, at a kernel's first row, profiled, its time
            plain_ms = None if out["rows"] else device_ms(run_plain, reps=1, warmup=0)
            if not kept:
                run_plain()
            torch.cuda.synchronize()
            bad = mismatches(got, kept[-1])
            out["mismatches"] += bad
            # TG timed at its first row (the others' times: PERF.md, path (k) alone)
            ms = device_ms(kernel) if name != "TG" or not out["rows"] else None
            written = sum(t.numel() * t.element_size() for t in (got if isinstance(got, tuple) else (got,)))
            b_ms, b_by = bound(16 + read + written,
                               work.get("hashes", 0) * TF_HASH_OPS + (MRG_STEP_OPS * RAND_N if name == "TM" else 0),
                               INT32_OPS)
            out["rows"][label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                                  "mismatches": bad, "hashes": work.get("hashes", 0), "rounds": work.get("rounds")}
            log(f"{name} {label} at {RAND_N} values: {bad} elements differ from the plain version; device ms "
                f"{ms}, plain {plain_ms}, bound {b_ms:.4f} ({b_by}; {work.get('hashes', 0)} hashes"
                f"{'' if work.get('rounds') is None else ', R ' + str(work['rounds'])})"
                f"{'' if ms is None else f', {b_ms / ms:.1%} of it'}")
        first = next(iter(out["rows"].values()))
        out.update(ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
                   bound_by=first["bound_by"], library_ms=None)
        res[name] = out
    # PyTorch's samplers of the same distributions at the same parameters:
    # other bits, a note for later work, not the library column (CUDA events)
    lam = torch.as_tensor(_resized(LOOP_LAM, dtype="float32"), device=dev)
    cnt, prb = (torch.as_tensor(_resized(v), device=dev) for v in (LOOP_COUNT, LOOP_PROB))
    res["TG"]["torch_standard_gamma_ms"] = call_ms(lambda: torch._standard_gamma(gam))
    res["TP"]["torch_poisson_ms"] = call_ms(lambda: torch.poisson(lam))
    res["TB"]["torch_binomial_ms"] = call_ms(lambda: torch.binomial(cnt, prb))
    log(f"PyTorch's samplers (other bits) at the same parameters, by CUDA events: _standard_gamma "
        f"{res['TG']['torch_standard_gamma_ms']} ms, poisson {res['TP']['torch_poisson_ms']} ms, binomial "
        f"{res['TB']['torch_binomial_ms']} ms")
    log(f"TP, TB and TM resources: {loop_kernel_info(rl._library())}")
    if any(r["mismatches"] for r in res.values()):
        raise AssertionError(f"(k) a loop kernel differs from its plain version: "
                             f"{ {k: r['mismatches'] for k, r in res.items()} }")
    return res


def run_random() -> dict:
    """(k2): every distribution ported by the loop kernels' PR at RAND_N
    values from one stream and one captured function (its 3 counted calls:
    eager, capture, replay), each call bitwise an eager twin's from the same
    seed and the keys after it the twin's; the draws of call 1 checked by
    moments."""
    from scipy import stats

    specs = random_specs(stats)
    t0 = time.perf_counter()
    cap, cap_srng = build_random("cuda", specs)
    eag, eag_srng = build_random("cuda", specs, use_graph=False)
    log(f"(k2) {len(specs)} draws of {RAND_N} values compiled twice: {time.perf_counter() - t0:.2f} s")
    zero_counters()
    worst = {}
    previous = None
    for call in range(N_RANDOM_CALLS):
        t0 = time.perf_counter()
        got, want = cap(), eag()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        for (label, _, groups), a, b in zip(specs, got, want):
            if not torch.equal(a, b):
                raise AssertionError(f"(k2) call {call + 1}: {label} captured differs from eager")
        for (ra, _), (rb_, _) in zip(cap_srng.state_updates, eag_srng.state_updates):
            if not np.array_equal(ra.get_value(), rb_.get_value()):
                raise AssertionError(f"(k2) call {call + 1}: a key after the captured call is not the eager one's")
        if previous is not None and any(torch.equal(a, b) for a, b in zip(got, previous)
                                        if a.numel() > 1):
            raise AssertionError(f"(k2) call {call + 1} drew a value array of the call before")
        if call == 0:
            for (label, _, groups), value in zip(specs, got):
                if isinstance(groups, list):
                    worst[label] = float(max(check_moments(label, value, groups)))
                else:
                    ok, z = check_other(label, value)
                    if not ok:
                        raise AssertionError(f"(k2) {label}: check failed (z {z})")
                    worst[label] = float(z)
        log(f"(k2) call {call + 1} ({'eager' if call == 0 else 'capture' if call == 1 else 'replay'} and its "
            f"eager twin): {secs:.2f} s, every draw bitwise the twin's, keys the twin's")
        previous = got
    counters = _all_counters()
    launches = {k: c.launches for k, c in counters.items()}
    replayed = {k: c.replayed for k, c in counters.items()}
    plain = sum(c.plain_calls for c in counters.values())
    log(f"(k2) launches over {N_RANDOM_CALLS} calls of each function {launches}, replayed {replayed}, plain calls "
        f"{plain}; worst moment z by draw {dict((k, round(v, 2)) for k, v in worst.items())}")
    if plain or any(launches[k] == 0 or replayed[k] == 0 for k in ("TG", "TP", "TB", "TF")):
        raise AssertionError("(k2) a loop kernel was not launched and replayed on the path")
    require_captured(cap, "(k2) draws")
    del cap, eag, got, want, previous
    release()
    return {"launches": launches, "replayed": replayed, "worst_z": worst}


def run_mrg() -> dict:
    """(k3): MRG31k3p streams, RAND_N uniforms in float32 and float64 and
    normals and binomials from one MRG_RandomStream in one captured
    function, against its eager twin (bitwise, states too) and moments."""
    import aesara_tpu_torch as ptp
    from aesara_tpu_torch.sandbox.rng_mrg import MRG_RandomStream, guess_n_streams

    def build(use_graph):
        rs = MRG_RandomStream(seed=SEED + 2024)
        outs = [rs.uniform(size=(RAND_N,), dtype="float32"), rs.uniform(size=(RAND_N,), dtype="float64"),
                rs.normal(size=(RAND_N,), dtype="float64"), rs.binomial(size=(RAND_N,), p=0.3)]
        return ptp.function([], outs, mode=ptp.Mode(ptp.TorchLinker(device="cuda", use_graph=use_graph))), rs

    from scipy import stats

    (cap, rs_c), (eag, rs_e) = build(None), build(False)
    zero_counters()
    for call in range(N_RANDOM_CALLS):
        got, want = cap(), eag()
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(got, want)) and all(
            np.array_equal(a.get_value(), b.get_value()) for (a, *_), (b, *_) in zip(rs_c.state_updates,
                                                                                    rs_e.state_updates))
        if not same:
            raise AssertionError(f"(k3) call {call + 1}: captured draws or states differ from eager")
        if call == 0:
            z = [float(max(check_moments(f"mrg {name}", v, [dist])))
                 for name, v, dist in zip(("uniform32", "uniform64", "normal", "binomial"), got,
                                          (stats.uniform(), stats.uniform(), stats.norm(), stats.bernoulli(0.3)))]
    counters = _all_counters()
    launches = {k: c.launches for k, c in counters.items()}
    replayed = {k: c.replayed for k, c in counters.items()}
    log(f"(k3) MRG31k3p, {guess_n_streams((RAND_N,))} streams x {-(-RAND_N // guess_n_streams((RAND_N,)))} steps: "
        f"{N_RANDOM_CALLS} calls bitwise their eager twin's, states too; launches {launches}, replayed {replayed}; "
        f"moment z {[round(v, 2) for v in z]}")
    if launches["TM"] == 0 or replayed["TM"] == 0:
        raise AssertionError("(k3) TM was not launched and replayed")
    require_captured(cap, "(k3) MRG draws")
    del cap, eag
    release()
    return {"launches": launches, "replayed": replayed, "z": z}


def phase_ctc_random() -> dict:
    """Path (k): (k1), the loop kernels' checks, (k2) and (k3)."""
    t_path = time.perf_counter()
    out = {}
    for key, run in (("k1", run_ctc), ("loops", loop_kernel_checks), ("k2", run_random), ("k3", run_mrg)):
        t0 = time.perf_counter()
        out[key] = run()
        log(f"({key}) {time.perf_counter() - t0:.2f} s")
    log(f"(k) path: {time.perf_counter() - t_path:.2f} s")
    return out


def ctc_random_only():
    """--ctc-random: the setup and path (k) alone."""
    phase_setup()
    start_cpu_references("ctc")
    phase_ctc_random()
    stop_cpu_references()
    log("chip_smoke --ctc-random: path (k) passed")


#: the jobs of ``cpu_reference``'s process, in the order it runs them
# ---------------------------------------------------------------------------
# path (l): bf16 and fp16 beyond PR 16 — the decoder served in bf16
# (bench_decode.py's bf16 half), the LSTM in bf16, the encoder in fp16,
# run_model_scale, and K2/K3 in fp16, at D 160 and 256 and past 65,535
# batch-heads
# ---------------------------------------------------------------------------

# (l1) a differing token is a tie where the CPU's top-2 logit gap is under
# bf16's spacing, 2**-7, of the logits' scale (fp32's rule is TIE_REL)
TIE_REL_BF16 = 2.0**-7
L1_TIMED = 3                  # (l1) calls timed back to back after the 3 counted ones
FP16_STEP_REL = 1e-2          # (l3) the fp16 step card vs CPU, of each tensor's scale
L_LSTM_BATCH = 8              # (l2) the step held against the CPU
# (l5) K2 and K3 alone: (dtype, panel); the last, 65,600 batch-heads, passes gridDim.y's 65,535
L_PANELS = ((torch.float16, (BATCH * N_HEADS, SEQ, D_MODEL // N_HEADS)), (torch.float32, (32, SEQ, 256)),
            (torch.bfloat16, (32, SEQ, 256)), (torch.float16, (32, SEQ, 256)), (torch.float32, (32, SEQ, 160)),
            (torch.bfloat16, (32, SEQ, 160)), (torch.float32, (65600, 16, 64)))


class Lazy:
    """A function built on its first call (the tie rule's oracle, compiled
    only where a token differs)."""

    def __init__(self, build):
        self.build, self.fn = build, None

    def __call__(self, *args):
        if self.fn is None:
            self.fn = self.build()
        return self.fn(*args)


def l1_functions(lm):
    """bench_decode.py's bf16 calls of ``lm``, verbatim (mode "FAST_RUN"),
    under ``floatX`` bfloat16: greedy, 32 streams, a 256-token prompt then
    8, and the int8 copy's greedy."""
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models.quant import quantize_decoder_int8

    with config.change_flags(floatX="bfloat16"):
        qlm = quantize_decoder_int8(lm)
        return {"l1a": lm.generate_fn(n_steps=DEC_STEPS, t_max=DEC_T_MAX, mode="FAST_RUN"),
                "l1b": lm.generate_batched_fn(batch=DEC_BATCH, n_steps=DEC_STEPS, t_max=DEC_T_MAX, mode="FAST_RUN"),
                "l1c": lm.generate_from_prompt_fn(prompt_len=DEC_PROMPT, n_new=DEC_NEW, t_max=DEC_T_MAX,
                                                  mode="FAST_RUN"),
                "l1d": qlm.generate_fn(n_steps=DEC_STEPS, t_max=DEC_T_MAX, mode="FAST_RUN")}


def l_prompt() -> np.ndarray:
    return (np.arange(DEC_PROMPT, dtype="int64") * 7) % DEC_VOCAB


def build_lstm_16(device: str, dtype: str, batch: int, with_grads: bool = False, float64_twin: bool = False):
    """Path (f)'s ``LSTM(SCAN_DIN, SCAN_H, LSTM_NOUT)`` in ``dtype`` from
    seed 0, adam at LSTM_LR, on ``batch`` rows of path (f)'s X and labels
    (seed 5): (step, each parameter's adam moments (m, v), params, x, y);
    with ``with_grads`` the step returns the loss and the gradients that
    its updates take; with ``float64_twin`` the model is float64 from the
    ``dtype`` model's values and the step returns the loss and gradients
    and updates nothing (adam's float32 counter takes no float64 update),
    and there are no moments."""
    import aesara_tpu_torch as ptp
    import aesara_tpu_torch.tensor as pt
    from aesara_tpu_torch.config import config
    from aesara_tpu_torch.models import LSTM, adam
    from aesara_tpu_torch.scalar.ops import from_host, to_host

    mode = ptp.Mode(ptp.TorchLinker(device=device))
    rng = np.random.default_rng(5)
    xv = rng.normal(size=(SCAN_T, SCAN_B, SCAN_DIN))[:, :batch]
    yv = rng.integers(0, LSTM_NOUT, size=SCAN_B).astype("int32")[:batch]
    with config.change_flags(device=device, floatX=dtype):
        start = LSTM(SCAN_DIN, SCAN_H, LSTM_NOUT, seed=0)
    run = "float64" if float64_twin else dtype
    with config.change_flags(device=device, floatX=run):
        model = LSTM(SCAN_DIN, SCAN_H, LSTM_NOUT, seed=0)
        for p, s in zip(model.params, start.params):
            p.set_value(from_host(to_host(s.get_value(), dtype), run))
        X, y = pt.tensor3("X", dtype=run), pt.ivector("y")
        loss = model.loss(X, y)
        updates = [] if float64_twin else adam(loss, model.params, lr=LSTM_LR)
        outputs = [loss] + ptp.grad(loss, model.params) if with_grads or float64_twin else ptp.Out(loss, borrow=True)
        step = ptp.function([X, y], outputs, updates=updates, mode=mode)
    # adam's updates: the step counter's, then (m, v, p) for each parameter
    moments = [(updates[1 + 3 * i][0], updates[2 + 3 * i][0]) for i in range(len(model.params))] if updates else None
    x = card_tensor(to_host(xv, dtype), run, device)
    return step, moments, model.params, x, torch.as_tensor(yv).to(device)


def l_cpu_reference() -> dict:
    """Path (l)'s CPU side, made in ``cpu_reference``'s process: (l1) the
    bf16 decoder's greedy tokens, the prompt's and the int8 copy's; (l2)
    the bf16 LSTM's loss and gradients at L_LSTM_BATCH rows (those of its
    first step), their float64 twin's distance from them (``own``) and the
    parameters after that step;
    (l3) the fp16 encoder step at batch 1 (``bf16_cpu_reference``)."""
    from aesara_tpu_torch.config import config

    t0 = time.perf_counter()
    out = {}
    with config.change_flags(device="cpu"):
        fns = l1_functions(build_decoder("cpu", floatX="bfloat16"))
        out["l1a"] = _host(fns["l1a"](np.int64(DEC_FIRST)))
        out["l1c"] = _host(fns["l1c"](l_prompt()))
        out["l1d"] = _host(fns["l1d"](np.int64(DEC_FIRST)))
    del fns
    step, _, params, x, y = build_lstm_16("cpu", "bfloat16", L_LSTM_BATCH, with_grads=True)
    g = [v.float().numpy() for v in step(x, y)]
    exact = build_lstm_16("cpu", "bfloat16", L_LSTM_BATCH, float64_twin=True)
    out["l2"] = {"grads": g, "own": [float(np.abs(a - b.numpy()).max()) for a, b in zip(g, exact[0](*exact[3:]))],
                 "params": [(p.name, p.value.float().numpy()) for p in params]}
    out["l3"] = bf16_cpu_reference("float16")
    out["seconds"] = time.perf_counter() - t0
    return out


def run_l1() -> dict:
    """(l1): ``DecoderLM(32000, 4, 512, 8, 2048, seed=0)`` in bfloat16 served
    as bench_decode.py serves it, tokens against the CPU's under the tie
    rule at bf16's spacing."""
    from aesara_tpu_torch.models.quant import quantize_decoder_int8

    t0 = time.perf_counter()
    lm = build_decoder("cuda", floatX="bfloat16")
    fns = l1_functions(lm)
    log(f"(l1) bf16 DecoderLM({DEC_VOCAB}, {DEC_LAYERS}, {DEC_D}, {DEC_HEADS}, {DEC_FF}), its int8 copy and the four "
        f"functions compiled: {time.perf_counter() - t0:.2f} s; weights {lm.embed.value.dtype}")
    cpu = {}

    def cpu_model(int8: bool):
        """The CPU's bf16 model (its int8 copy), for the tie rule's oracle."""
        from aesara_tpu_torch.config import config

        with config.change_flags(floatX="bfloat16"):
            if "lm" not in cpu:
                cpu["lm"] = build_decoder("cpu", floatX="bfloat16")
            return last_logits_fn(quantize_decoder_int8(cpu["lm"]) if int8 else cpu["lm"])

    oracle, q_oracle = Lazy(lambda: cpu_model(False)), Lazy(lambda: cpu_model(True))
    t0 = time.perf_counter()
    nodes = [pair for name, full in (("l1a", (DEC_T_MAX,)), ("l1b", (DEC_BATCH, DEC_T_MAX)), ("l1c", (DEC_PROMPT,)),
                                     ("l1d", (DEC_T_MAX,))) for pair in decoder_composites(fns[name], full)]
    composites = check_decoder_composites(nodes, "(l1)", time_each=False)
    log(f"(l1) K1 on {len(composites)} distinct Composites: {time.perf_counter() - t0:.1f} s")
    out = {"composites": composites}
    first = np.int64(DEC_FIRST)
    # one profiled session in (l1), (l1c)'s: a 256-step loop's takes 20-30 s
    out["l1a"] = run_decoder_fn(fns["l1a"], lambda: fns["l1a"](first), "(l1a) bf16 greedy decode", DEC_STEPS,
                                DEC_STEPS, n_timed=L1_TIMED, profile=False)
    out["l1b"] = run_decoder_fn(fns["l1b"], lambda: fns["l1b"](np.arange(DEC_BATCH, dtype="int64")),
                                "(l1b) bf16 batched decode, 32 streams", DEC_STEPS, DEC_BATCH * DEC_STEPS,
                                n_timed=L1_TIMED, profile=False)
    prompt = l_prompt()
    out["l1c"] = run_decoder_fn(fns["l1c"], lambda: fns["l1c"](prompt), "(l1c) bf16 prompt prefill + decode",
                                DEC_NEW - 1, DEC_PROMPT, unit="prompt tokens", n_timed=L1_TIMED)
    out["l1d"] = run_decoder_fn(fns["l1d"], lambda: fns["l1d"](first), "(l1d) bf16 int8 greedy decode", DEC_STEPS,
                                DEC_STEPS, n_timed=L1_TIMED, profile=False)
    ref = cpu_reference("l")
    out["l1a"]["agree"] = tie_rule("(l1a) card against CPU", out["l1a"]["out"], ref["l1a"], [DEC_FIRST], oracle,
                                   TIE_REL_BF16)
    out["l1b"]["agree"] = [tie_rule(f"(l1b) stream {j} against single-stream decode", out["l1b"]["out"][:, j],
                                    _host(fns["l1a"](np.int64(j))), [j], oracle, TIE_REL_BF16) for j in range(2)]
    out["l1c"]["agree"] = tie_rule("(l1c) card against CPU", out["l1c"]["out"], ref["l1c"], list(prompt), oracle,
                                   TIE_REL_BF16)
    out["l1d"]["agree"] = tie_rule("(l1d) int8 card against CPU", out["l1d"]["out"], ref["l1d"], [DEC_FIRST],
                                   q_oracle, TIE_REL_BF16)
    log(f"(l1) tokens agreeing with the CPU's (tie rule at {TIE_REL_BF16} of the scale): greedy {out['l1a']['agree']}"
        f" of {DEC_STEPS}, streams 0 and 1 {out['l1b']['agree']}, prompt {out['l1c']['agree']} of {DEC_NEW}, int8 "
        f"{out['l1d']['agree']} of {DEC_STEPS}")
    del fns, lm
    release()
    return out


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """bfloat16's spacing at each entry of ``x`` (its smallest subnormal at 0)."""
    _, e = torch.frexp(x.double().abs())   # |x| = f 2^e, f in [0.5, 1)
    return torch.ldexp(torch.ones_like(x, dtype=torch.float64), e - 8).clamp_min(2.0**-133)


def adam_plain(p, m, v, g, t: int, lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One adam step in plain torch for a 16-bit parameter, as the port's
    adam defines it: float32 moments and constants, bias corrections in
    float32, the update cast to ``p``'s type; (new p, new m, new v)."""
    g = g.float()
    m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
    bc1, bc2 = (float(np.float32(1) - np.float32(b) ** np.float32(t)) for b in (b1, b2))
    return (p.float() - lr * (m / bc1) / ((v / bc2).sqrt() + eps)).to(p.dtype), m, v


def step_spacing(got, want, start):
    """bfloat16's spacing at the larger of a step's start and its two
    results, entry by entry: the grain of ``start - update`` (where the
    update cancels the start, the result's own spacing is finer than the
    float32 update's error: K1's pow, within libdevice's 2 ulp, puts
    1 - 0.999**t 1e-4 of itself off)."""
    big = torch.maximum(torch.maximum(got.double().abs(), want.double().abs()), start.double().abs().to(got.device))
    return bf16_ulp(big)


def check_adam_step(label: str, t: int, params, moments, before, grads):
    """Each bfloat16 parameter after adam's step ``t`` within one spacing
    (``step_spacing``) of ``adam_plain`` on the gradients that the step
    returned (the two compute the same float32 values in another order,
    then round), and
    the float32 moments within 1e-6 of their scale; but at the entries
    whose gradient is under one bf16 spacing of its tensor's scale
    (2**-8 of its largest magnitude): there the sign and size of a sum are
    rounding's, and near adam's eps, 1e-8, a rounding of the gradient moves
    the update by a share of lr.  A step that updated nothing, or with the
    sign flipped, is off by lr (2 lr) at every other entry, several
    spacings at the LSTM's parameters.  Returns (the largest difference in
    spacings, the entries left out, of how many)."""
    worst, out, total = 0.0, 0, 0
    for p, (m, v), (p0, m0, v0), g in zip(params, moments, before, grads):
        want_p, want_m, want_v = adam_plain(p0, m0, v0, g, t, LSTM_LR)
        g64 = g.double().abs()
        keep = g64 > 2.0**-8 * g64.max().item()
        out, total = out + int((~keep).sum()), total + keep.numel()
        off = (p.value.double() - want_p.double()).abs()
        ulps = off / step_spacing(p.value, want_p, p0)
        kept = ulps[keep]
        worst = max(worst, kept.max().item() if kept.numel() else 0.0)
        beyond = ulps > 1.0
        if beyond.any():
            log(f"{label}: step {t} {p.name}: {int(beyond.sum())} of {ulps.numel()} entries beyond one spacing "
                f"({int((beyond & keep).sum())} kept), the largest {ulps.max().item()}; their gradients at most "
                f"{(g64[beyond].max() / g64.max()).item():.3e} of the scale")
        if p.value.dtype != p0.dtype or not (kept <= 1.0).all():
            i = int(torch.where(keep, ulps, torch.zeros_like(ulps)).argmax())
            raise AssertionError(
                f"{label}: step {t} {p.name} {p.value.dtype} off plain adam by {ulps.flatten()[i].item()} spacings "
                f"at entry {i}: gradient {g.flatten()[i].item()} (scale {g64.max().item()}), start "
                f"{p0.flatten()[i].item()}, got {p.value.flatten()[i].item()}, plain {want_p.flatten()[i].item()}")
        for name, got, want in (("m", m.value, want_m), ("v", v.value, want_v)):
            err = (got - want)[keep].abs().max().item() if keep.any() else 0.0
            if not err <= 1e-6 * want.abs().max().item():
                raise AssertionError(f"{label}: step {t} {p.name}'s {name} off plain adam by {err}")
    return worst, out, total


def run_l2() -> dict:
    """(l2): path (f)'s LSTM in bfloat16 with adam: 3 counted steps and 5
    timed, the loss finite and falling; then at L_LSTM_BATCH rows 3 steps,
    each held against plain adam on the step's own gradients
    (``check_adam_step``), and the first against the CPU: the loss and
    gradients within BF16_REL of each tensor's scale plus the CPU's own
    distance from float64, and the parameters after it within one spacing
    of the CPU's, but at the entries where the CPU's gradient lies within
    that gate (its sign is rounding's: adam moves such an entry by lr one
    way or the other)."""
    label = "(l2) bf16 LSTM with adam"
    step, _, params, x, y = build_lstm_16("cuda", "bfloat16", SCAN_B)
    per_call, nodes = scan_launches(step)
    rows = check_composites(nodes, label, np.random.default_rng(43), full=(SCAN_T, SCAN_B, SCAN_H),
                            time_each=False)
    torch.cuda.synchronize()
    reset_peak()
    zero_counters()
    losses = [float(step(x, y)) for _ in range(N_SCAN_STEPS)]
    launches = read_counters(per_call, label, N_SCAN_STEPS)
    t = time_steps(lambda: step(x, y), N_SCALE_TIMED, label)
    require_captured(step, label)
    after = float(step(x, y))
    log(f"{label}: losses {losses}, {after} after {N_SCAN_STEPS + N_SCALE_TIMED} steps and more; {t['ms']:.3f} ms a "
        f"step, host {t['host']:.3f} ms a call, busy {t['busy']} of {t['wall']:.3f} ms, peak {t['peak']:.3f} GiB")
    if not (np.isfinite(after) and after < losses[0]):
        raise AssertionError(f"{label}: the loss did not fall: {losses} -> {after}")
    del step
    step, moments, params, x, y = build_lstm_16("cuda", "bfloat16", L_LSTM_BATCH, with_grads=True)
    ref = cpu_reference("l")["l2"]
    names = [p.name for p in params]
    worst, left_out = 0.0, []
    for n in range(1, N_SCAN_STEPS + 1):
        before = [(p.value.clone(), m.value.clone(), v.value.clone()) for p, (m, v) in zip(params, moments)]
        out = step(x, y)
        ulps, n_out, n_all = check_adam_step(label, n, params, moments, before, out[1:])
        worst = max(worst, ulps)
        left_out.append(f"{n_out}/{n_all}")
        if n > 1:
            continue
        compare_bf16(f"{label}: loss and gradients at batch {L_LSTM_BATCH}, card vs CPU", out, ref["grads"],
                     ["loss"] + [f"d{n}" for n in names], own=ref["own"])
        kept = []
        for k, (p, (name, want), (p0, _, _)) in enumerate(zip(params, ref["params"], before)):
            g = torch.from_numpy(ref["grads"][k + 1]).double()
            keep = g.abs() > BF16_REL * g.abs().max().item() + ref["own"][k + 1]
            got, want = p.value.double().cpu(), torch.from_numpy(want).double()
            ulps = ((got - want).abs() / step_spacing(got, want, p0.cpu()))[keep]
            if ulps.numel() and not ulps.max().item() <= 1.0:
                raise AssertionError(f"{label}: step 1 {name} off the CPU's by {ulps.max().item()} spacings")
            kept.append(f"{name} {int(keep.sum())}/{keep.numel()}")
        log(f"{label}: step 1's parameters within one spacing of the CPU's at the entries whose CPU gradient is "
            f"past its gate (kept: {', '.join(kept)})")
    log(f"{label}: {N_SCAN_STEPS} steps at batch {L_LSTM_BATCH} within {worst} spacings of plain adam on their own "
        f"gradients (entries left out, their gradient under 2**-8 of its scale: {', '.join(left_out)})")
    del step, moments, params
    release()
    return dict(t, launches=launches, composites=rows)


def run_l3() -> dict:
    """(l3): the flagship encoder's sgd step in float16 (path (i1)'s, from
    the same bfloat16 start; the loss, a mean of 8 M values, in float32:
    ``build_bf16_step``), 3 counted and 10 timed; a batch-1 step against
    the CPU within FP16_STEP_REL of each tensor's scale plus the CPU's own
    distance from float64."""
    label = "(l3) fp16 encoder train"
    t0 = time.perf_counter()
    step, params = build_bf16_step("cuda", dtype="float16", loss_dtype="float32")
    log(f"{label} step compile: {time.perf_counter() - t0:.2f} s; graph {op_census(step)}")
    k1_err, k1_rel, _, _ = phase_k1(step, np.random.default_rng(18), timed_shape=None, time_each=False)
    reset_peak()
    losses, launches, per_call = counted_steps(step, label, dtype=torch.float32)
    t = time_steps(step, N_TIMED_STEPS, f"{label} step")
    require_captured(step, label)
    log(f"{label}: {BATCH * SEQ / t['ms'] * 1e3:.1f} tokens/s, {t['ms']:.3f} ms a step; launches a step {per_call}; "
        f"host {t['host']:.3f} ms; busy {t['busy']} of {t['wall']:.3f} ms; peak {t['peak']:.3f} GiB")
    del step, params
    release()
    step, params, grads = build_bf16_step("cuda", batch=1, with_grads=True, dtype="float16", loss_dtype="float32")
    g = grads()
    loss = float(step())
    ref = cpu_reference("l")["l3"]
    names = [name for name, _ in ref["params"]]
    compare_bf16(f"{label}: gradients at batch 1, card vs CPU", g, ref["grads"],
                 ["loss"] + [f"d{name}" for name in names], own=ref["own"], rel=FP16_STEP_REL)
    compare_bf16(f"{label}: step at batch 1, card vs CPU", [loss] + [p.value for p in params],
                 [ref["loss"]] + [torch.from_numpy(v) for _, v in ref["params"]], ["loss"] + names,
                 rel=FP16_STEP_REL)
    del step, params, grads, g
    release()
    return dict(t, launches=launches, per_call=per_call, k1_err=k1_err, k1_rel=k1_rel)


def run_l4(scale_arm=None) -> dict:
    """(l4): ``bench_transformer.run_model_scale``, SCALE_LAYERS x (2048, 16,
    8192) at 8 x 2048 tokens in bfloat16, remat off: (i2)'s remat-off arm
    (``scale_arm``, or run here under --fp16), its loss finite and falling
    after the counted and timed steps."""
    arm = run_scale_arm(False) if scale_arm is None else scale_arm
    losses, after, t = arm["losses"], arm["final_loss"], arm["t"]
    label = f"(l4) run_model_scale {SCALE_LAYERS}L d={SCALE_D} ff={SCALE_FF} bf16"
    log(f"{label}: (i2)'s remat-off arm: {t['ms']:.3f} ms a step, {arm['tok_s']:.1f} tokens/s; launches a step "
        f"{arm['per_call']}; peak {t['peak']:.3f} GiB; losses {losses}, {after} after "
        f"{N_TRAIN_STEPS + N_SCALE_TIMED} steps")
    if not (np.isfinite(after) and after < losses[0]):
        raise AssertionError(f"{label}: the loss did not fall: {losses} -> {after}")
    return dict(t, launches=arm["launches"], per_call=arm["per_call"], tok_s=arm["tok_s"])


def l5_attention_checks(occupancy: bool = True) -> dict:
    """(l5): K2 and K3 alone at L_PANELS (``check_attention``), their
    resources, and FusedAttention graphs at D 256 (fp32) and in fp16
    compiled through ``function()`` and run on the card against the plain
    version.  The main run makes them early, with the other kernel checks
    (and logs the resources there, not again: ``occupancy``)."""
    import aesara_tpu_torch as ptp
    import aesara_tpu_torch.tensor as pt
    from aesara_tpu_torch.link.torch.kernels.attention import attention_plain, flash_attention

    t0 = time.perf_counter()
    if occupancy:
        k2_occupancy()
        k3_occupancy()
    out = {}
    for dtype, shape in L_PANELS:
        out[(str(dtype).split(".")[-1], shape)] = check_attention(shape, dtype)
        release()
    for dtype, shape in (("float32", (4, 300, 256)), ("float16", (16, 512, 64))):
        q, k, v = (pt.tensor3(n, dtype=dtype) for n in "qkv")
        f = ptp.function([q, k, v], pt.fused_attention(q, k, v, causal=True))
        gen = torch.Generator(device="cuda").manual_seed(21)
        args = [torch.randn(shape, device="cuda", generator=gen).to(getattr(torch, dtype)) for _ in range(3)]
        before = flash_attention.launches
        got = f(*args)
        want = attention_plain(*args, True, shape[-1] ** -0.5)
        err = (got.float() - want.float()).abs().max().item()
        if flash_attention.launches != before + 1 or not err <= ATTENTION_REL[args[0].dtype] * want.float().abs().max():
            raise AssertionError(f"(l5) FusedAttention {dtype} {shape} through function(): err {err}, launches "
                                 f"{flash_attention.launches - before}")
        log(f"(l5) a causal FusedAttention {dtype} {shape} compiled through function() ran K2 on the card: max err "
            f"{err:.3e} against the plain version")
    log(f"(l5) K2/K3 fp16, D 160 and 256, 65,600 batch-heads: {time.perf_counter() - t0:.2f} s")
    return out


def phase_l(attention=None, scale_arm=None) -> dict:
    """Path (l): (l5) (unless made before, ``attention``), (l1)-(l4) ((l4)
    from (i2)'s remat-off arm where given, ``scale_arm``)."""
    out = {"l5": attention if attention is not None else l5_attention_checks()}
    for name, run in (("l1", run_l1), ("l2", run_l2), ("l3", run_l3), ("l4", lambda: run_l4(scale_arm))):
        t0 = time.perf_counter()
        out[name] = run()
        log(f"({name}) path: {time.perf_counter() - t0:.2f} s")
    return out


def fp16_only():
    """--fp16: the setup and path (l) alone."""
    phase_setup()
    start_cpu_references("l")
    phase_l()
    stop_cpu_references()
    log("chip_smoke --fp16: path (l) passed")


CPU_REF_JOBS = {"adamw": adamw_cpu_reference, "decoder": cpu_decoder_references, "bf16": bf16_cpu_reference,
                "lm_train": lm_train_cpu_reference, "ctc": ctc_cpu_reference, "l": l_cpu_reference}


# ---------------------------------------------------------------------------
# every path captured and eager, in one process
# ---------------------------------------------------------------------------

def _host(value):
    """A result on the host, to compare after the function is gone: a
    tensor's values, a SciPy matrix's values (its pattern is x's)."""
    if value is None:       # a function without outputs
        return []
    if isinstance(value, (list, tuple)):
        return [_host(v) for v in value]
    if isinstance(value, torch.Tensor):
        from aesara_tpu_torch.scalar.ops import to_host

        return to_host(value, str(value.dtype).split(".")[-1]).copy()
    return np.asarray(value.data).copy()


def _paths(ng, glm):
    """(label, build(use_graph) -> (function, call, state variables)) of
    every path the smoke drives, each built from the same seeds."""
    ng_x, ng_y = ng
    glm_x, glm_y, glm_w = glm
    request = np.random.default_rng(100).normal(size=(BATCH, SEQ, D_MODEL)).astype("float32")
    rhs = np.random.default_rng(14).normal(size=(GLM_D, max(GRAD_WIDTHS))).astype("float32")
    docs = ng_x[:NG_REQUEST_DOCS]

    def forward(g):
        fn = compile_encoder("cuda", use_graph=g)
        return fn, lambda: fn(request), []

    def train(optimizer):
        def build(g):
            step, _, state = build_train_step("cuda", optimizer=optimizer, use_graph=g)
            return step, step, state
        return build

    def classifier(g):
        model, step, _ = build_logistic("cuda", ng_x, ng_y, use_graph=g)
        return step, step, model.params

    def predict(g):
        _, _, fn = build_logistic("cuda", ng_x, ng_y, use_graph=g)
        return fn, lambda: fn(docs), []

    def glm_step(recipe):
        def build(g):
            step, state = build_glm("cuda", glm_x, glm_y, glm_w, recipe, use_graph=g)
            return step, step, state
        return build

    def values_grad(g):
        fn = build_values_grad("cuda", use_graph=g)
        return fn, lambda: fn(glm_x, rhs), []

    def mnist_mlp(g):
        built = build_reference(3, "cuda", use_graph=g)
        return built["step"], reference_call(built, 3), built["params"]

    def scan_step(which):
        def build(g):
            built = build_scan_path(which, "cuda", use_graph=g)
            return built["step"], built["call"], built["params"]
        return build

    def greedy(g):
        fn = build_decoder("cuda").generate_fn(DEC_CAPTURE_STEPS, DEC_T_MAX, mode=decoder_mode(g))
        return fn, lambda: fn(np.int64(DEC_FIRST)), []

    def sampled(g):
        fn = build_decoder("cuda").generate_fn(SAMPLE_CAPTURE_STEPS, DEC_T_MAX, temperature=SAMPLE_T,
                                               top_k=SAMPLE_TOPK, mode=decoder_mode(g))
        return fn, lambda: fn(np.int64(DEC_FIRST)), [rng_key(fn)]

    def batcher(chunk):
        def build(g):
            from aesara_tpu_torch.models.serve import ContinuousBatcher

            srv = ContinuousBatcher(build_decoder("cuda", SERVE_VOCAB), n_slots=SERVE_SLOTS, t_max=SERVE_T_MAX,
                                    t_pad=SERVE_T_PAD, chunk=chunk, mode=decoder_mode(g))
            rng = np.random.default_rng(0)
            for _ in range(SERVE_SLOTS):
                srv.submit(rng.integers(0, SERVE_VOCAB, size=SERVE_PROMPT).astype("int64"), max_new=SERVE_NEW)
            return srv._decode, srv._decode, srv._caches + [srv._pos, srv._cur, srv._act]
        return build

    def bf16_train(g):
        step, params = build_bf16_step("cuda", use_graph=g)
        return step, step, params

    def lm_train(g):
        from aesara_tpu_torch.models.checkpoint import state_shareds

        lm, updates, train = build_lm_train("cuda", use_graph=g)
        rows, calls = train_rows(), iter(range(1 << 30))
        return train, lambda: train(rows[next(calls) % TRAIN_ROWS]), state_shareds(lm.params, updates)

    return [("encoder forward request", forward), ("encoder train step (sgd)", train("sgd")),
            ("(d) encoder train step (AdamW)", train("adamw")), ("(a) classifier train step", classifier),
            ("(a) predict, one request again", predict), ("(b) GLM train step", glm_step("sgd")),
            ("(b) GLM adam step", glm_step("adam")), ("(c) values gradient, width 20", values_grad),
            ("(e) config 3 MNIST MLP step", mnist_mlp), ("(f) config 4 Elman RNN step", scan_step("config4")),
            ("(f) LSTM step", scan_step("lstm")), (f"(g1) greedy decode, {DEC_CAPTURE_STEPS} tokens", greedy),
            (f"(h1) sampled decode, top-k {SAMPLE_TOPK}, {SAMPLE_CAPTURE_STEPS} tokens", sampled),
            ("(g5) batcher _decode, chunk 1", batcher(1)), ("(g5) batcher _decode, chunk 16", batcher(16)),
            ("(i1) bf16 encoder train step (sgd)", bf16_train), ("(i3) DecoderLM train step (AdamW, loss scaling)",
                                                                  lm_train)]


def _difference(captured, eager) -> tuple:
    """(largest |difference|, largest |difference| over its tensor's
    largest |value|, whether every one is bitwise equal) of two lists of
    host arrays."""
    diff, rel, same = 0.0, 0.0, True
    for a, b in zip(captured, eager):
        a, b = np.asarray(a), np.asarray(b)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"captured {a.shape} {a.dtype} against eager {b.shape} {b.dtype}")
        same = same and np.array_equal(a, b, equal_nan=True)
        d = float(np.abs(a.astype("float64") - b.astype("float64")).max()) if a.size else 0.0
        scale = float(np.abs(b.astype("float64")).max()) if b.size else 0.0
        diff, rel = max(diff, d), max(rel, d / scale if scale else d)
    return diff, rel, same


def phase_capture(ng, glm):
    """Every path compiled twice from the same seeds and compared,
    ``capture_row`` each."""
    return [capture_row(label, build) for label, build in _paths(ng, glm)]


def capture_row(label: str, build):
    """One path compiled twice from the same seeds: captured (the default)
    and eager (``use_graph=False``), one after the other, each driven
    alike: 4 calls (eager, captured, replayed twice), then back to back,
    host time of one call and a profile (``time_steps``).  Each prints its
    step time, host time of one call, device busy share, peak and
    reserved memory and BLAS ops; the captured run's results after the 4
    calls (every call's outputs, then every piece of state) against the
    eager run's: bitwise, or else within CAPTURE_REL of each tensor's
    largest value (cuBLAS may pick another algorithm under capture).
    Returns (label, bitwise equal, largest difference)."""
    t_row = time.perf_counter()
    runs = {}
    for use_graph in (True, False):
        mode = "captured" if use_graph else "eager"
        t0 = time.perf_counter()
        fn, call, state = build(use_graph)
        compile_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        reset_peak()
        # eager, captured, replayed twice; compared before the timing,
        # whose profile may take the step a varying number of times
        outs = [_host(call()) for _ in range(N_COMPARED_CALLS)]
        require_captured(fn, f"{label}, {mode}", captured=use_graph)
        compared = dict(outs=[a for out in outs for a in (out if isinstance(out, list) else [out])],
                        state=[_host(v.value) if v.type.dtype == "bfloat16" else v.get_value()
                               for v in state])
        # the captured run profiled (its launches held to the trace, as in
        # the main phases); the eager one not since PR 21: an eager decode
        # loop's session took 10-18 s, the phase's time went to path (l)
        t = time_steps(call, N_TIMED_STEPS, f"{label}, {mode}", profile=use_graph)
        runs[mode] = dict(t, **compared, blas=blas_counts(fn), compile_s=compile_s)
        del fn, call, state
        release()
    cap, eag = runs["captured"], runs["eager"]
    diff, rel, same = _difference(cap["outs"] + cap["state"], eag["outs"] + eag["state"])
    for mode, r in runs.items():
        busy = ("not profiled (eager)" if r["busy"] is None
                else f"{r['busy']:.3f} of {r['wall']:.3f} ms ({100 * r['busy'] / r['wall']:.1f}%)")
        log(f"capture table | {label} | {mode} | {r['ms']:.3f} ms back to back | host {r['host']:.3f} ms a "
            f"call | busy {busy} | peak "
            f"{r['peak']:.3f} GiB, reserved {r['reserved']:.3f} GiB | compile {r['compile_s']:.2f} s | "
            f"{r['blas']}")
    log(f"capture table | {label} | captured vs eager over {len(cap['outs'])} outputs and "
        f"{len(cap['state'])} state variables: {'bitwise equal' if same else 'not bitwise equal'}, largest "
        f"difference {diff:.3e} ({rel:.3e} of its tensor's scale)")
    if not same and rel > CAPTURE_REL:
        raise AssertionError(f"{label}: captured and eager differ by {rel:.3e} of a tensor's scale")
    log(f"capture table | {label} | both runs in {time.perf_counter() - t_row:.2f} s")
    return label, same, diff


def kernel_line(name, route, source, replaces, key, path, res):
    """One kernel's entry: ``path`` is the (launches, replayed) of its
    path's counted run and the launches its profiled replays showed in the
    trace, each by kernel; ``res`` its check against the plain version."""
    (launches, replayed), traced = path
    return {"name": name, "route": route, "source": source, "replaces": replaces, "launches": launches[key],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            "replayed": replayed[key], "profiled_launches": traced[key]}


def k6_sweep():
    """K6's tuning table: device ms at the four shapes of its paths for
    each chunk size and short-row factor, every variant checked against
    the plain version, in two rounds (the second in reverse order) with
    torch.sparse.mm timed before and after each round."""
    from aesara_tpu_torch.link.torch.csr import CSRMat
    from aesara_tpu_torch.link.torch.kernels import sparse

    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}")
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(15)
    xv, _ = newsgroups_like()
    a = CSRMat.from_scipy(xv, cuda, with_transpose=True)
    glm = CSRMat.from_scipy(glm_data()[0], cuda)
    # the scales of phase_logistic's W and g
    w = torch.randn((NG_FEATURES, NG_CLASSES), device=cuda, generator=gen) * 0.01
    g = torch.randn((NG_DOCS, NG_CLASSES), device=cuda, generator=gen) * 1e-3
    shapes = {"forward": (a, w), "twin": (a.transpose(), g),
              "request": (CSRMat.from_scipy(xv[:NG_REQUEST_DOCS], cuda), w),
              "(c) width 20": (glm, torch.randn((GLM_D, 20), device=cuda, generator=gen))}
    variants = [(chunk, short) for chunk in (64, 128, 256, 512) for short in (0, 2, 4, 8)]
    times: dict = {}
    for label, (m, b) in shapes.items():
        want = sparse.csr_matmul_plain(m, b, torch.float32)
        fresh = label == "request"        # the plan made in the call, as predict makes it

        def run(chunk, short):
            mat = CSRMat(m.indptr, m.indices, m.data, m.shape) if fresh else m
            return sparse.csr_spmm(mat, b, torch.float32, chunk=chunk, short=short)

        for chunk, short in variants:
            torch.testing.assert_close(run(chunk, short), want, atol=SPARSE_TOL, rtol=SPARSE_TOL)
        A = torch_csr(m)
        lib = [library_ms(label, lambda: torch.sparse.mm(A, b))]
        for order in (variants, variants[::-1]):
            for chunk, short in order:
                times.setdefault((label, chunk, short), []).append(device_ms(lambda: run(chunk, short)))
            lib.append(library_ms(label, lambda: torch.sparse.mm(A, b)))
        log(f"K6 {label}: {m.shape} nnz {m.nnz} @ {tuple(b.shape)}; torch.sparse.mm device ms "
            f"{[round(t, 4) for t in lib]} (before, between and after the rounds); plain checks passed")
        for chunk, short in variants:
            t = times[(label, chunk, short)]
            log(f"  chunk {chunk:4d} short {short}: device ms {t[0]:.4f} {t[1]:.4f}")
    print(smi)


def spread(times) -> str:
    return f"median {statistics.median(times):.6f} (min {min(times):.6f}, max {max(times):.6f})"


def versus(mine, theirs) -> str:
    """Both tests of one set of rounds against another, each beyond the
    spread of the rounds: the slowest of ``mine`` beats the fastest of
    ``theirs``, or the fastest of ``mine`` loses to the slowest of theirs."""
    return f"wins beyond the spread: {max(mine) < min(theirs)}, loses beyond it: {min(mine) > max(theirs)}"


def k7_sweep():
    """K7's tuning table at the GLM's x (path (c)), widths 1 and 20: each
    chunk size of the plan, checked against the plain version, then timed
    in two rounds (the second in reverse order) with
    torch.sparse.sampled_addmm before, between and after them; and the
    one-off device time of making the plan at each chunk size."""
    from aesara_tpu_torch.link.torch.csr import CSRMat
    from aesara_tpu_torch.link.torch.kernels import sparse

    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}")
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(19)
    a = CSRMat.from_scipy(glm_data()[0], cuda)
    for chunk in K7_CHUNKS:
        plan_ms = device_ms(lambda: sparse.merge_path_plan(a.indptr, a.nnz, chunk))
        log(f"K7 plan at chunk {chunk}: {sparse.spmm_plan(a, chunk).shape[0] - 1} chunks, made once in "
            f"{plan_ms:.4f} device ms")
    for C in GRAD_WIDTHS:
        gz = torch.randn((GLM_N, C), device=cuda, generator=gen)
        b = torch.randn((GLM_D, C), device=cuda, generator=gen)
        want = sparse.csr_sddmm_plain(a, gz, b)
        out = torch.empty_like(a.data)

        def run(chunk):
            sparse.launch_sddmm(a, gz, b, out, chunk)
            return out

        for chunk in K7_CHUNKS:
            torch.testing.assert_close(run(chunk).clone(), want, atol=SPARSE_TOL, rtol=SPARSE_TOL)
        A, bt = torch_csr(a), b.t().contiguous()
        lib_ms = [library_ms("K7", lambda: torch.sparse.sampled_addmm(A, gz, bt, beta=0.0))]
        times: dict = {}
        for order in (K7_CHUNKS, K7_CHUNKS[::-1]):
            for chunk in order:
                times.setdefault(chunk, []).append(device_ms(lambda: run(chunk)))
            lib_ms.append(library_ms("K7", lambda: torch.sparse.sampled_addmm(A, gz, bt, beta=0.0)))
        bound_ms, bound_by = bound(sddmm_bytes(a, C), 2 * a.nnz * C)
        log(f"K7 GLM x {a.shape} nnz {a.nnz}, width {C}: every chunk within the tolerance; bound "
            f"{bound_ms:.4f} ({bound_by}); sampled_addmm device ms {[round(t, 4) for t in lib_ms if t]} "
            f"(before, between and after the rounds)")
        for chunk in K7_CHUNKS:
            log(f"  chunk {chunk:4d}: device ms {times[chunk][0]:.4f} {times[chunk][1]:.4f}")
    print(smi)


K4_EMPTY_SOURCE = """import triton


@triton.jit
def empty(x_ptr):
    pass
"""


def graph_timer(fn, launches: int = K4_LAUNCHES):
    """A function that replays a CUDA graph of ``launches`` calls of ``fn``
    between two CUDA events and returns the device ms per call: the
    kernels back to back, with no host launch cost between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timer():
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / launches

    return timer


def eager_ms(fn, launches: int = K4_LAUNCHES) -> float:
    """ms per call of ``launches`` calls of ``fn`` launched from the host
    between two CUDA events (where the host launches slower than the device
    runs, this is the host's rate)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / launches


def host_ms(fn, calls: int = 2000) -> float:
    """Host ms a call of ``fn`` over ``calls`` calls back to back (by the
    host's clock, the device synchronised after)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return ms


def k4_rounds(timers: dict, rounds: int = K4_ROUNDS, eager: dict = None):
    """``rounds`` rounds of every timer of ``timers`` in turns (every other
    round in reverse order): the graph ms a launch of each, and, for the
    names that ``eager`` maps to their functions, the eager ms a launch in
    the same turn."""
    graph_t: dict = {}
    eager_t: dict = {}
    for rnd in range(rounds):
        for name in (list(timers) if rnd % 2 == 0 else list(timers)[::-1]):
            graph_t.setdefault(name, []).append(timers[name]())
            if eager and name in eager:
                eager_t.setdefault(name, []).append(eager_ms(eager[name]))
    return graph_t, eager_t


def k4_lane_grid(m: int, n: int, tile: int):
    """(blocks, lanes a row) of K4's lane-group launch for fp32 rows of
    ``n`` values whose rows are 16-byte multiples, as ``geometry`` in
    softmax_rows.cu makes them: a power of two of lanes a row, one 16-byte
    vector a lane, ``tile`` threads a block."""
    lanes = min(32, 1 << (-(-n // 4) - 1).bit_length())
    return -(-m // (tile // lanes)), lanes


def k4_times():
    """K4 timed against torch.log_softmax at the classifier's (11314, 20)
    fp32: K4 as the wrapper launches it, the library call and two launch
    floors on K4's grid (an empty kernel of K4's own CUDA library, launched
    the same way, and an empty Triton kernel), in K4_ROUNDS rounds of K4_LAUNCHES
    launches each, in turns, timed by CUDA events around a CUDA graph of
    the launches and around eager launches, with each one's kernel time by
    the profiler, and the host time a call of the wrapper and of its
    pieces.  Then the sweep of the lane groups' block (K4_TILES
    threads, so rows a block), each checked against the plain version, in
    K4_ROUNDS rounds with the library before every round and after the
    last, and the fastest block, the kept one and the library alone, in
    turns.  Then, each checked against the plain version and timed in
    K4_SWEEP_ROUNDS rounds at about K4_SWEEP_VALUES values: every regime
    and tile that takes each width of K4_REGIME_WIDTHS (log-softmax,
    fp32), and K4 against torch.softmax and torch.log_softmax at K4_WIDTHS
    in fp32 and bf16.  Each comparison prints both tests beyond the spread
    (``versus``)."""
    from aesara_tpu_torch.link.torch.kernels.build import triton_module
    from aesara_tpu_torch.link.torch.kernels.softmax import (
        BLOCK_ROWS, LANE_GROUPS, TWO_PASS, launch_plan, launch_softmax, softmax_rows, softmax_rows_plain,
    )

    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}")
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn((NG_DOCS, NG_CLASSES), device=cuda, generator=gen)
    m, n = x.shape
    want = softmax_rows_plain(x, log=True)
    regime, tile = launch_plan(n)
    blocks, lanes = k4_lane_grid(m, n, tile)
    empty = triton_module(K4_EMPTY_SOURCE, "k4_floor").empty
    out = torch.empty_like(x)
    contenders = {"K4": lambda: softmax_rows(x, log=True),
                  "torch.log_softmax": lambda: torch.log_softmax(x, dim=-1),
                  "empty CUDA kernel": lambda: launch_softmax(x, out, True, regime, tile, floor=True),
                  "empty Triton kernel": lambda: empty[(blocks,)](x, num_warps=tile // 32)}
    torch.testing.assert_close(softmax_rows(x, log=True), want, atol=SPARSE_TOL, rtol=SPARSE_TOL)
    graph_t, eager_t = k4_rounds({name: graph_timer(fn) for name, fn in contenders.items()}, eager=contenders)
    log(f"K4 log-softmax {tuple(x.shape)} fp32, launch: regime {regime}, {blocks} blocks of {tile} threads, "
        f"{lanes} lanes a row; {K4_ROUNDS} rounds of {K4_LAUNCHES} launches, in turns")
    for name, fn in contenders.items():
        log(f"  {name}: graph ms a launch {spread(graph_t[name])}; eager {spread(eager_t[name])}; "
            f"kernel (profiler) {device_ms(fn):.6f}")
    log(f"  K4 against torch.log_softmax: graph rounds {versus(graph_t['K4'], graph_t['torch.log_softmax'])}; "
        f"eager rounds {versus(eager_t['K4'], eager_t['torch.log_softmax'])}")
    bound_ms, bound_by = bound(2 * x.numel() * 4, 6 * x.numel())
    log(f"  bound {bound_ms:.6f} ({bound_by})")
    # where an eager launch's host time goes: each piece alone, host clock
    pieces = {"softmax_rows (the wrapper)": contenders["K4"],
              "launch_softmax (out given)": lambda: launch_softmax(x, out, True, regime, tile),
              "launch_softmax of the empty kernel": contenders["empty CUDA kernel"],
              "torch.empty_like": lambda: torch.empty_like(x),
              "torch.cuda.current_stream().cuda_stream": lambda: torch.cuda.current_stream(cuda).cuda_stream,
              "torch._C._cuda_getCurrentRawStream": lambda: torch._C._cuda_getCurrentRawStream(0),
              "torch.log_softmax": contenders["torch.log_softmax"]}
    for name, fn in pieces.items():
        log(f"  host ms a call, {name}: {host_ms(fn):.6f}")

    def group_launch(threads):
        res = torch.empty_like(x)
        return lambda: (launch_softmax(x, res, True, LANE_GROUPS, threads), res)[1]

    launches = {t: group_launch(t) for t in K4_TILES}
    for fn in launches.values():
        torch.testing.assert_close(fn().clone(), want, atol=SPARSE_TOL, rtol=SPARSE_TOL)
    timers = {t: graph_timer(fn) for t, fn in launches.items()}
    lib_timer = graph_timer(contenders["torch.log_softmax"])
    sweep: dict = {}
    lib_t = [lib_timer()]
    for rnd in range(K4_ROUNDS):
        for t in (K4_TILES if rnd % 2 == 0 else K4_TILES[::-1]):
            sweep.setdefault(t, []).append(timers[t]())
        lib_t.append(lib_timer())
    log(f"K4 sweep of the lane groups' block at {tuple(x.shape)} (graph ms a launch, {K4_ROUNDS} rounds); "
        f"torch.log_softmax {spread(lib_t)} (before every round and after the last)")
    for t in K4_TILES:
        log(f"  {t:3d} threads, {t // lanes} rows a block ({k4_lane_grid(m, n, t)[0]} blocks): {spread(sweep[t])}; "
            f"kernel (profiler) {device_ms(launches[t]):.6f}")
    best = min(K4_TILES, key=lambda t: statistics.median(sweep[t]))
    log(f"K4 fastest: {best} threads a block, {spread(sweep[best])}; against torch.log_softmax: "
        f"{versus(sweep[best], lib_t)}")
    final_t, _ = k4_rounds({"fastest": timers[best], "kept": timers[tile] if tile in timers else
                            graph_timer(group_launch(tile)), "torch.log_softmax": lib_timer})
    log(f"K4 in turns, {K4_ROUNDS} rounds (graph ms a launch): fastest ({best} threads) "
        f"{spread(final_t['fastest'])}; kept ({tile} threads) {spread(final_t['kept'])}; torch.log_softmax "
        f"{spread(final_t['torch.log_softmax'])}")
    log(f"  fastest against the kept launch: {versus(final_t['fastest'], final_t['kept'])}; against "
        f"torch.log_softmax: {versus(final_t['fastest'], final_t['torch.log_softmax'])}; the kept launch against "
        f"torch.log_softmax: {versus(final_t['kept'], final_t['torch.log_softmax'])}")

    names = {LANE_GROUPS: "lane groups", BLOCK_ROWS: "block rows", TWO_PASS: "two passes"}
    log(f"K4 regimes (log-softmax, fp32, about {K4_SWEEP_VALUES} values; graph ms a launch, median of "
        f"{K4_SWEEP_ROUNDS} rounds; * the plan's launch)")
    for w in K4_REGIME_WIDTHS:
        xw = torch.randn((max(1, K4_SWEEP_VALUES // w), w), device=cuda, generator=gen)
        want_w = softmax_rows_plain(xw, log=True)
        options = [(LANE_GROUPS, t) for t in (64, 128, 256) if w <= 1024]
        options += [(BLOCK_ROWS, t) for t in (128, 256, 512) if w <= 32 * t]
        options += [(TWO_PASS, t) for t in (256, 1024) if w >= 1024]
        fns = {}
        for opt in options:
            res = torch.empty_like(xw)
            fns[opt] = lambda opt=opt, res=res, xw=xw: (launch_softmax(xw, res, True, *opt), res)[1]
            torch.testing.assert_close(fns[opt]().clone(), want_w, atol=SPARSE_TOL, rtol=SPARSE_TOL)
        timers = {opt: graph_timer(fn) for opt, fn in fns.items()}
        timers["torch.log_softmax"] = graph_timer(lambda xw=xw: torch.log_softmax(xw, dim=-1))
        t, _ = k4_rounds(timers, K4_SWEEP_ROUNDS)
        plan = launch_plan(w)
        cells = [f"{names[opt[0]]} {opt[1]}{'*' if opt == plan else ''} {statistics.median(t[opt]):.6f}"
                 for opt in options]
        log(f"  width {w} ({xw.shape[0]} rows): {'; '.join(cells)}; torch.log_softmax "
            f"{statistics.median(t['torch.log_softmax']):.6f}")
        del xw, want_w, fns, timers

    log(f"K4 widths against the library (about {K4_SWEEP_VALUES} values; graph ms a launch, {K4_SWEEP_ROUNDS} "
        f"rounds)")
    for dtype in (torch.float32, torch.bfloat16):
        for w in K4_WIDTHS:
            xw = torch.randn((max(1, K4_SWEEP_VALUES // w), w), device=cuda, generator=gen).to(dtype)
            tol = SPARSE_TOL if dtype == torch.float32 else BF16_REL
            for log_sm in (False, True):
                torch.testing.assert_close(softmax_rows(xw, log_sm), softmax_rows_plain(xw, log_sm), atol=tol,
                                           rtol=tol)
                lib = torch.log_softmax if log_sm else torch.softmax
                t, _ = k4_rounds({"K4": graph_timer(lambda: softmax_rows(xw, log_sm)),
                                  "library": graph_timer(lambda: lib(xw, dim=-1))}, K4_SWEEP_ROUNDS)
                bound_ms, bound_by = bound(2 * xw.numel() * xw.element_size(), 6 * xw.numel())
                log(f"  {str(dtype)[6:]} width {w} ({xw.shape[0]} rows) {'log-softmax' if log_sm else 'softmax'}: "
                    f"K4 {spread(t['K4'])}; {lib.__name__} {spread(t['library'])}; K4 "
                    f"{versus(t['K4'], t['library'])}; launch {launch_plan(w)}; bound {bound_ms:.6f} "
                    f"({bound_by})")
            del xw
    print(smi)


def k4_k7_times():
    """K7 at the GLM's x, widths 1 and 20, and K4 at (11314, 20) fp32, each
    checked against its plain version and timed through its wrapper beside
    its library call (K4 in K4_ROUNDS rounds in turns with the library, in
    CUDA graphs and eagerly).  It reads only the wrappers, so a copy of this
    script placed in another checkout times that checkout's kernels: two
    checkouts are compared in one call by running the two in turns (a, b,
    b, a)."""
    from aesara_tpu_torch.link.torch.csr import CSRMat
    from aesara_tpu_torch.link.torch.kernels.softmax import softmax_rows, softmax_rows_plain
    from aesara_tpu_torch.link.torch.kernels.sparse import csr_sddmm, csr_sddmm_plain

    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}; checkout {sys.path[0]}")
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(21)
    a = CSRMat.from_scipy(glm_data()[0], cuda)
    for C in GRAD_WIDTHS:
        gz = torch.randn((GLM_N, C), device=cuda, generator=gen)
        b = torch.randn((GLM_D, C), device=cuda, generator=gen)
        torch.testing.assert_close(csr_sddmm(a, gz, b).data, csr_sddmm_plain(a, gz, b), atol=SPARSE_TOL,
                                   rtol=SPARSE_TOL)
        A, bt = torch_csr(a), b.t().contiguous()
        ms = [device_ms(lambda: csr_sddmm(a, gz, b)) for _ in range(3)]
        lib = library_ms("K7", lambda: torch.sparse.sampled_addmm(A, gz, bt, beta=0.0))
        log(f"K7 GLM x, width {C}: device ms {[round(t, 4) for t in ms]}; sampled_addmm {lib}")
    x = torch.randn((NG_DOCS, NG_CLASSES), device=cuda, generator=gen)
    torch.testing.assert_close(softmax_rows(x, log=True), softmax_rows_plain(x, log=True), atol=SPARSE_TOL,
                               rtol=SPARSE_TOL)
    fns = {"K4": lambda: softmax_rows(x, log=True), "torch.log_softmax": lambda: torch.log_softmax(x, dim=-1)}
    graph_t, eager_t = k4_rounds({name: graph_timer(fn) for name, fn in fns.items()}, eager=fns)
    log(f"K4 {tuple(x.shape)}: kernel (profiler) {device_ms(fns['K4']):.6f}, graph ms a launch "
        f"{spread(graph_t['K4'])}; torch.log_softmax {spread(graph_t['torch.log_softmax'])}; K4 "
        f"{versus(graph_t['K4'], graph_t['torch.log_softmax'])}")
    log(f"K4 {tuple(x.shape)} eager ms a launch {spread(eager_t['K4'])}; torch.log_softmax "
        f"{spread(eager_t['torch.log_softmax'])}; K4 {versus(eager_t['K4'], eager_t['torch.log_softmax'])}")
    print(smi)


def loop_small_rows() -> list:
    """--loop-times' small draws: (kernel, label, the draw's arguments after
    the key) of TP and of TB in float64 and float32 at LOOP_SMALL_N values,
    path (k)'s cycled parameters cut to each size."""
    rows = []
    for n in LOOP_SMALL_N:
        lam = torch.as_tensor(_resized(LOOP_LAM, n, "float32"), device="cuda")
        cnt, prb = (torch.as_tensor(_resized(v, n), device="cuda") for v in (LOOP_COUNT, LOOP_PROB))
        rows += [("TP", f"float32 lam, {n} values", (lam,)), ("TB", f"float64, {n} values", (cnt, prb)),
                 ("TB", f"float32, {n} values", (cnt.float(), prb.float()))]
    return rows


def loop_times():
    """TP and TB through their wrappers, each checked bitwise against its
    plain version: at path (k)'s RAND_N values (``tp_tb_rows``: its cycled
    parameters, then uniform ones; TB in float64 and float32) timed in
    LOOP_TIME_ROUNDS profiled sessions (device ms of the whole call, and
    split by kernel) beside the hashes and bound of the plain version's
    ``work``; at LOOP_SMALL_N values (``loop_small_rows``) and in a
    multinomial (MULTINOMIAL_DRAWS draws over MULTINOMIAL_P's categories, a
    scan of TB, checked against the same draw on the CPU), ms a call of
    LOOP_GRAPH_CALLS calls replayed in a CUDA graph (the median of three
    replays; launch gaps count) and device ms.  Then the checkout's ``-Xptxas
    -v`` figures for both kernels.  It reads only the wrappers and the
    multinomial's draw, so a copy of this script placed in another checkout
    times that checkout's kernels: two checkouts are compared in one call by
    running the two in turns (a, b, b, a)."""
    from aesara_tpu_torch.link.torch.kernels import random_loops as rl
    from aesara_tpu_torch.tensor.random.basic import multinomial
    from aesara_tpu_torch.tensor.random.op import prng_key

    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}; checkout {sys.path[0]}")
    t0 = time.perf_counter()
    lib = rl._library()
    log(f"random_loops nvcc build + load: {time.perf_counter() - t0:.2f} s")
    if hasattr(lib, "random_loops_kernel_info"):
        log(f"loop kernels' resources: {loop_kernel_info(lib)}")
    key = torch.as_tensor(prng_key(SEED + 18)).cuda()
    bad_rows = []

    def check(label, got, want):
        bad = mismatches(got, want)
        if bad:
            bad_rows.append(label)
        return bad

    for name, label, args, read in tp_tb_rows():
        work: dict = {}

        def kernel():
            return tp_tb_draw(name, key, args)

        got = kernel()
        bad = check(f"{name} {label}", got, tp_tb_plain(name, key, args, work))
        times, split = [], {}
        for _ in range(LOOP_TIME_ROUNDS):
            by_name = device_split(kernel)
            times.append(sum(by_name.values()))
            for k, t in by_name.items():
                m = re.search(r"\w+_kernel(<[^>]*>)?", k)
                short = m.group(0) if m else k[:40]
                split[short] = split.get(short, 0.0) + t / LOOP_TIME_ROUNDS
        b_ms, b_by = bound(16 + read + got.numel() * got.element_size(), work.get("hashes", 0) * TF_HASH_OPS,
                           INT32_OPS)
        log(f"{name} {label}: {bad} elements differ from the plain version; device ms "
            f"{' '.join(f'{t:.4f}' for t in times)}; by kernel {dict((k, round(v, 4)) for k, v in split.items())}; "
            f"{work.get('hashes', 0)} hashes, R {work.get('rounds')}, bound {b_ms:.4f} ({b_by}), "
            f"{b_ms / statistics.median(times):.1%} of it")

    def small(label, fn, bad):
        timer = graph_timer(fn, LOOP_GRAPH_CALLS)
        graph = statistics.median(timer() for _ in range(3))
        log(f"{label}: {bad} elements differ; {graph:.4f} ms a call in a graph of {LOOP_GRAPH_CALLS}, device ms "
            f"{device_ms(fn):.4f}")

    for name, label, args in loop_small_rows():
        fn = lambda name=name, args=args: tp_tb_draw(name, key, args)  # noqa: E731
        small(f"{name} {label}", fn, check(f"{name} {label}", fn(), tp_tb_plain(name, key, args, None)))
    n = torch.tensor(MULTINOMIAL_COUNT, dtype=torch.float64)
    p = torch.tensor(MULTINOMIAL_P, dtype=torch.float64)
    size = (MULTINOMIAL_DRAWS,)
    n_card, p_card = n.cuda(), p.cuda()
    fn = lambda: multinomial.sample_key(key, size, n_card, p_card)  # noqa: E731
    label = f"multinomial, {MULTINOMIAL_DRAWS} draws of {MULTINOMIAL_COUNT:g} over {len(MULTINOMIAL_P)} categories"
    small(label, fn, check(label, fn().cpu(), multinomial.sample_key(key.cpu(), size, n, p)))
    for line in ptxas_report():
        log(f"ptxas -v {line}")
    print(smi)
    if bad_rows:
        raise AssertionError(f"--loop-times: rows that differ from their plain versions: {bad_rows}")


def mrg_times():
    """TM alone through its wrapper at MRG_TIME_ROWS, each row checked
    bitwise (draws and new state) against its plain version on the CPU:
    device ms (LOOP_TIME_ROUNDS profiled sessions of 20 calls), ms a call of
    LOOP_GRAPH_CALLS calls replayed in a CUDA graph (the median of three
    replays; launch gaps count), the bound (bytes: the state read and
    written and the draws written, or MRG_STEP_OPS integer operations a
    value at INT32_OPS) and its share, and TM's registers
    (``random_loops_kernel_info``).  Where the checkout cuts streams into
    chunks (``mrg_chunks``, ``_mrg_launch``), the rows' chunks and, at the
    first four rows, a sweep of the chunk length over MRG_SWEEP_CHUNKS.  It
    reads only the wrapper otherwise, so a copy of this script placed in
    another checkout times that checkout's kernel: two checkouts are
    compared in one call by running the two in turns (a, b, b, a)."""
    from aesara_tpu_torch.link.torch.kernels import random_loops as rl
    from aesara_tpu_torch.sandbox.rng_mrg import guess_n_streams

    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}; checkout {sys.path[0]}")
    t0 = time.perf_counter()
    lib = rl._library()
    log(f"random_loops nvcc build + load: {time.perf_counter() - t0:.2f} s")
    log(f"TM resources: {loop_kernel_info(lib, (7, 8))}")
    chunked = hasattr(rl, "_mrg_launch")
    bad_rows, wants = [], {}
    for label, streams, n, dt in MRG_TIME_ROWS:
        streams = streams or guess_n_streams((n,))
        steps = -(-n // streams)
        state = mrg_state(streams)
        fn = lambda state=state, n=n, dt=dt: rl.mrg_draw(state, n, dt)  # noqa: E731
        want = wants[label, dt] = rl.mrg_plain(state.cpu(), n, dt)
        got = fn()
        bad = mismatches(tuple(t.cpu() for t in got), want)
        if bad:
            bad_rows.append(f"{label} {dt}")
        times = [device_ms(fn) for _ in range(LOOP_TIME_ROUNDS)]
        timer = graph_timer(fn, LOOP_GRAPH_CALLS)
        graph = statistics.median(timer() for _ in range(3))
        b_ms, b_by = bound(2 * state.numel() * 4 + got[1].numel() * got[1].element_size(), MRG_STEP_OPS * n,
                           INT32_OPS)
        split = ""
        if chunked:
            chunk, chunks = rl.mrg_chunks(streams, steps, rl._slots(state.device))
            split = f", chunks of {chunk}, {chunks} of them"
        log(f"TM {label}, {dt} ({streams} streams x {steps} steps{split}): {bad} elements differ from the plain "
            f"version; device ms {' '.join(f'{t:.4f}' for t in times)}; {graph:.4f} ms a call in a graph of "
            f"{LOOP_GRAPH_CALLS}; bound {b_ms:.4f} ({b_by}), {b_ms / statistics.median(times):.1%} of it")
        del timer, got
        release()
    for label, streams, n, dt in MRG_TIME_ROWS[:4] if chunked else ():
        state, steps = mrg_state(streams), -(-n // streams)
        for chunk in MRG_SWEEP_CHUNKS:
            fn = lambda state=state, n=n, dt=dt, chunk=chunk: rl._mrg_launch(state, n, dt, chunk)  # noqa: E731
            bad = mismatches(tuple(t.cpu() for t in fn()), wants[label, dt])
            if bad:
                bad_rows.append(f"{label} {dt} at chunks of {chunk}")
            log(f"TM sweep {label}, {dt}, chunks of {chunk} ({-(-steps // chunk)} a stream): {bad} elements "
                f"differ; device ms {device_ms(fn):.4f}")
    print(smi)
    if bad_rows:
        raise AssertionError(f"--mrg-times: rows that differ from their plain versions: {bad_rows}")


def attention_times():
    """K2 and K3 at the encoder's panels, (128, 1024, 64) fp32 and bf16,
    causal and not: device ms of K2, and of K3's call split into its
    backward kernels and K2's recompute.  It reads only the wrappers, so a
    copy of this script placed in another checkout times that checkout's
    kernels: two checkouts are compared in one call by running the two in
    turns (a, b, b, a)."""
    from aesara_tpu_torch.link.torch.kernels.attention import flash_attention, flash_attention_grads

    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}; checkout {sys.path[0]}")
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(17)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do = (torch.randn((128, 1024, 64), device=cuda, generator=gen).to(dtype) for _ in range(4))
        for causal in (False, True):
            k2 = device_ms(lambda: flash_attention(q, k, v, causal=causal, scale=0.125))
            split = device_split(lambda: flash_attention_grads(q, k, v, do, causal=causal, scale=0.125))
            bwd = sum(t for name, t in split.items() if "flash_bwd" in name)
            rec = sum(t for name, t in split.items() if "flash_fwd" in name)
            log(f"(128, 1024, 64) {str(dtype).split('.')[-1]} causal={causal}: K2 device ms {k2:.4f}; K3 call "
                f"{sum(split.values()):.4f} = backward kernels {bwd:.4f} + K2 recompute {rec:.4f} + other "
                f"{sum(split.values()) - bwd - rec:.4f}")
    print(smi)


def k2_variant(lib, q, k, v, causal: bool, scale: float):
    """(out, lse) of the K2 build ``lib`` on contiguous (BH, T, D) CUDA
    panels whose rows are 16-byte multiples, called as the wrapper calls
    it but outside it, so that no counter moves."""
    BH, T, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((BH, T), dtype=torch.float32, device=q.device)
    err = lib.flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(), BH, T, D,
                        float(scale), int(causal), 0 if q.dtype == torch.float32 else 1,
                        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: {lib.flash_fwd_error_string(err).decode()}")
    return out, lse


def k2_walk_sweep():
    """K2's walked key tile: the D <= 64 variants built with 16, 32 and 64
    rows (``FLASH_FWD_WALK``, one nvcc each, all at once), their resources,
    each checked against the plain version at the encoder's panels, fp32
    and bf16, causal and not, then timed in two rounds (the second in
    reverse order) with scaled_dot_product_attention timed before, between
    and after them."""
    from aesara_tpu_torch.link.torch.kernels.attention import _library, attention_plain

    smi = card_line()
    log(f"card: {smi}; torch {torch.__version__}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(K2_WALKS)) as pool:
        futures = {w: pool.submit(_library, "flash_fwd", (f"FLASH_FWD_WALK={w}",)) for w in K2_WALKS}
        libs = {w: f.result() for w, f in futures.items()}
    log(f"K2 builds with walked tiles of {K2_WALKS} rows: {time.perf_counter() - t0:.2f} s")
    for w, lib in libs.items():
        k2_occupancy(lib, f"K2 walk {w}:")
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda).manual_seed(16)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = (torch.randn((128, 1024, 64), device=cuda, generator=gen).to(dtype) for _ in range(3))
        scale = 1.0 / 8.0
        for causal in (False, True):
            want, want_lse = attention_plain(q, k, v, causal, scale, with_lse=True)
            tol = F32_ATOL if dtype == torch.float32 else BF16_REL * want.float().abs().max().item()
            for w, lib in libs.items():
                got, lse = k2_variant(lib, q, k, v, causal, scale)
                err, lse_err = (got.float() - want.float()).abs().max().item(), (lse - want_lse).abs().max().item()
                if not (err <= tol and lse_err <= F32_ATOL):
                    raise AssertionError(f"K2 walk {w} {dtype} causal={causal}: max err {err}, lse err {lse_err}")
            order = list(libs.items())
            times: dict = {}

            def sdpa():
                return torch.nn.functional.scaled_dot_product_attention(
                    q[None], k[None], v[None], is_causal=causal, scale=scale)

            lib_ms = [library_ms("K2", sdpa)]
            for rnd in (order, order[::-1]):
                for w, lib in rnd:
                    times.setdefault(w, []).append(device_ms(lambda: k2_variant(lib, q, k, v, causal, scale)))
                lib_ms.append(library_ms("K2", sdpa))
            log(f"K2 (128, 1024, 64) {str(dtype).split('.')[-1]} causal={causal}: every walk within the "
                f"tolerance; scaled_dot_product_attention device ms {[round(t, 4) for t in lib_ms if t]} "
                f"(before, between and after the rounds)")
            for w in libs:
                log(f"  walk {w:2d}: device ms {times[w][0]:.4f} {times[w][1]:.4f}")
    print(smi)


def load_card(seconds: float = PROFILE_LOAD_S):
    """Run fp32 GEMMs on the card for ``seconds``, as the encoder phases do."""
    a = torch.randn(4096, 4096, device="cuda")
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = (a @ a).clamp_(-1, 1)
    torch.cuda.synchronize()


def profile_check(sessions: int = 12, rounds: int = 3):
    """How often a profiled window (``profile_session``) of ``predict``
    on one 1,000-document request, captured and eager, loses launches
    from its trace, and how often every marker: ``rounds`` rounds of
    ``sessions`` sessions of each, taken in turns, each round after
    PROFILE_LOAD_S of GEMMs; between sessions the card idles 0.3 s.
    Raises if any session lost one."""
    smi = phase_setup()
    xv, yv = newsgroups_like()
    docs = xv[:NG_REQUEST_DOCS]
    calls = {}
    for use_graph in (True, False):
        _, _, fn = build_logistic("cuda", xv, yv, use_graph=use_graph)
        for _ in range(3):
            fn(docs)
        calls["captured" if use_graph else "eager"] = lambda fn=fn: fn(docs)
    lost = {mode: [0, 0] for mode in calls}
    for r in range(rounds):
        load_card()
        for i in range(sessions):
            for mode, call in calls.items():
                _, _, traced, counted, _, note = profile_session(call, f"(a) predict, {mode}")
                if traced != counted:
                    lost[mode][0] += 1
                    lost[mode][1] += note.startswith("no marker")
                    log(f"round {r}, session {i}, {mode}: trace {traced}, counters {counted}; {note}")
                time.sleep(0.3)
    log(f"sessions of {PROFILE_STEPS} predict calls that lost launches (of them, every marker), of "
        f"{rounds * sessions} after {PROFILE_LOAD_S} s of GEMMs a round: "
        f"{', '.join(f'{mode}: {n} ({m})' for mode, (n, m) in lost.items())}")
    print(smi)
    if any(n for n, _ in lost.values()):
        raise AssertionError(f"profiled windows of predict lost launches: {lost}")


def main():
    global SEED
    modes = {"--k6-sweep": k6_sweep, "--k2-walk-sweep": k2_walk_sweep, "--attention-times": attention_times,
             "--profile-check": profile_check, "--k7-sweep": k7_sweep, "--k4-times": k4_times,
             "--k4-k7-times": k4_k7_times, "--loop-times": loop_times, "--mrg-times": mrg_times,
             "--reference": reference_only, "--scan": scan_only, "--decoder": decoder_only,
             "--decoder-sampling": decoder_sampling_only, "--bf16": bf16_only, "--convnet": convnet_only,
             "--ctc-random": ctc_random_only, "--fp16": fp16_only}
    args = sys.argv[1:]
    if "--seed" in args:
        at = args.index("--seed")
        SEED = int(args[at + 1])
        del args[at:at + 2]
    if len(args) == 1 and args[0] in modes:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU")
        return modes[args[0]]()
    if args:
        raise SystemExit(f"chip_smoke: unknown arguments {args}")
    start = time.perf_counter()
    smi = phase_setup()
    start_cpu_references("adamw", "decoder", "bf16", "lm_train", "ctc", "l")
    log(f"setup (builds and first launches): {time.perf_counter() - start:.2f} s")
    t_path = time.perf_counter()
    t0 = time.perf_counter()
    fn = compile_encoder("cuda")
    log(f"compile (graph + rewrites + link): {time.perf_counter() - t0:.2f} s")
    check_graph(fn)
    k1_err, k1_times, k2_err, k2_times = phase_kernels(fn)
    requests, results, launches = phase_slice(fn)
    profile_request(fn, requests[-1])
    check_against_cpu(requests, results)
    steady, q1, q3 = steady_latency(fn, requests)
    log(f"full-width forward, steady request latency over 12 more requests: median {steady:.3f} "
        f"ms, quartiles {q1:.3f} / {q3:.3f} ms ({BATCH}x{SEQ} tokens)")
    del fn, requests, results
    release()
    log(f"encoder forward path (with the K1 and K2 checks): {time.perf_counter() - t_path:.2f} s")

    t_path = time.perf_counter()
    t0 = time.perf_counter()
    step, params, _ = build_train_step("cuda")
    log(f"train step compile (graph + grad + rewrites + link): {time.perf_counter() - t0:.2f} s")
    check_train_graph(step)
    k1_train_err, _, _, sgd_ops = phase_k1(step, np.random.default_rng(1))
    k3_err, k3_times = phase_k3()
    attention_bf16 = bf16_attention_checks()
    attention_l = l5_attention_checks(occupancy=False)
    _, train_counts = phase_train(step, params)
    train = (train_counts, time_train(step)["traced"])
    require_captured(step, "train step")
    del step, params
    release()
    check_train_against_cpu()
    log(f"encoder train path (with the K1, K3 and bf16 K2/K3 checks): {time.perf_counter() - t_path:.2f} s")
    t0 = time.perf_counter()
    adamw = phase_adamw(sgd_ops)
    log(f"(d) AdamW path: {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    lr = phase_logistic()
    log(f"(a) classifier path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    glm, glm_xyw = phase_glm()
    log(f"(b) GLM path: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    grad_values = phase_values_grad(glm_xyw[0])
    log(f"(c) values-gradient path: {time.perf_counter() - t0:.2f} s")
    reference = phase_reference()
    scans = phase_scan()
    seen = set()
    prep = prepare_sampling(seen)
    decoder = phase_decoder(seen)
    sampling = phase_sampling(prep, decoder["g1"]["out"])
    del prep
    release()
    t0 = time.perf_counter()
    bf16 = phase_bf16(attention_bf16)
    log(f"(i) bf16, remat and the decoder trained: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    convnet = phase_convnet()
    log(f"(j) conv net and control flow: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    ctc_random = phase_ctc_random()
    log(f"(k) CTC, the distributions and MRG31k3p: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    path_l = phase_l(attention_l, bf16["i2"]["arms"][False])
    log(f"(l) bf16 and fp16 beyond PR 16: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    phase_capture(lr["data"], glm_xyw)
    log(f"captured-vs-eager phase: {time.perf_counter() - t0:.2f} s")

    k1 = {"max_abs_err": max(k1_err, k1_train_err, adamw["k1_err"], glm["k1_err"]), "ms": k1_times[0],
          "plain_ms": k1_times[1], "bound_ms": k1_times[2], "bound_by": k1_times[3], "library_ms": None}
    # path 4d: the launches of its 3 counted steps, and K1 on the AdamW
    # update of a (d_model, d_ff) weight
    adamw_ms, adamw_plain_ms, adamw_bound_ms, adamw_bound_by, adamw_cold_ms = adamw["k1_times"]
    k1_adamw = {"adamw_launches": adamw["launches"]["K1"], "adamw_ms": adamw_ms, "adamw_cold_ms": adamw_cold_ms,
                "adamw_plain_ms": adamw_plain_ms, "adamw_bound_ms": adamw_bound_ms,
                "adamw_bound_by": adamw_bound_by}
    k2 = {"max_abs_err": k2_err, "ms": k2_times[0], "plain_ms": k2_times[1], "bound_ms": k2_times[2],
          "bound_by": k2_times[3], "library_ms": k2_times[4]}
    k3 = {"max_abs_err": k3_err, "ms": k3_times[0], "plain_ms": k3_times[1], "bound_ms": k3_times[2],
          "bound_by": k3_times[3], "library_ms": k3_times[4]}
    # the library call is handed out and logsumexp: K3's backward kernels alone compare with it
    k3_line = dict(kernel_line("K3 flash attention backward", "cuda", K3_SOURCE, K3_REPLACES, "K3", train, k3),
                   backward_ms=k3_times[5])
    k5 = dict(glm["K5"], max_abs_err=max(glm["K5"]["max_abs_err"], glm["K5_grad"]["max_abs_err"]))
    k6 = dict(lr["K6"], max_abs_err=max(r["max_abs_err"] for r in (
        lr["K6"], lr["K6_grad"], lr["K6_request"], grad_values["K6"])))
    k7 = dict(grad_values["K7"], max_abs_err=grad_values["K7_err"])
    # path (e): each configuration's launches in its 3 counted steps, and
    # K4 at config 2's softmax and the MLP's log-softmax
    labels = {1: "config1", 2: "config2", 3: "config3", "mlp": "mlp"}
    path_e = {k: {labels[w]: r["launches"][0][k] for w, r in reference.items()} for k in ("K1", "K4")}
    k1_e_err = max(row["max_abs_err"] for r in reference.values() for row in r["composites"])
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_e_err)
    k4_e = {labels[w]: {key: r["k4"][key] for key in ("max_abs_err", "ms", "cold_ms", "plain_ms", "bound_ms",
                                                       "library_ms")}
            for w, r in reference.items() if r["k4"] is not None}
    # path (f): each model's launches in its 3 counted steps (the inner
    # programs' launches a step times 128 steps), K1 on its Composites and
    # K4 at the LSTM's log-softmax
    path_f = {k: {w: r["launches"][0][k] for w, r in scans.items()} for k in ("K1", "K4")}
    k1["max_abs_err"] = max([k1["max_abs_err"]] + [row["max_abs_err"] for r in scans.values()
                                                    for row in r["composites"]])
    k4_f = {key: scans["lstm"]["k4"][key] for key in ("max_abs_err", "ms", "cold_ms", "plain_ms", "bound_ms",
                                                      "library_ms")}
    # path (g): each sub-path's launches in its counted run (the inner
    # programs' a step times the trip count; (g5): the replays of its
    # second drain), K1 on its Composites and K4 at its softmaxes
    g_paths = [k for k in decoder if k.startswith("g") and k != "g5"]
    path_g = {k: {w: (decoder[w]["launches"][0][k] + decoder[w]["launches"][1][k]) for w in g_paths}
              for k in ("K1", "K4")}
    k1["max_abs_err"] = max([k1["max_abs_err"]] + [row["max_abs_err"] for row in decoder["composites"]]
                            + [row["max_abs_err"] for row in sampling["composites"]])
    k4_g = {w: {key: r[key] for key in ("max_abs_err", "ms", "cold_ms", "plain_ms", "bound_ms", "library_ms")}
            for w, r in {**decoder["k4"], **sampling["k4"]}.items()}
    # path (h): each sub-path's launches in its counted run (the speculative
    # calls run eagerly: their launches), and the threefry kernel's line
    h_paths = ("h1k0", f"h1k{SAMPLE_TOPK}", "h3")
    path_h = {k: {w: sampling[w]["launches"][0][k] + sampling[w]["launches"][1][k] for w in h_paths}
              for k in ("K1", "K4", "TF")}
    for w in ("h2", "h2self"):
        for k in ("K1", "K4", "TF"):
            path_h[k][w] = sampling[w]["launches"].get(k, 0)
    h1 = sampling["h1k0"]
    tf_line = dict(kernel_line("TF threefry draw (no TPU kernel)", "triton", TF_SOURCE, TF_REPLACES, "TF",
                               (h1["launches"], h1["traced"]), sampling["tf"]),
                   float32=sampling["tf"]["float32"], path_b_launches=glm["launches"][0]["TF"],
                   path_h_launches=path_h["TF"])
    # path (i): each run's launches in its counted steps (the encoder's 3,
    # each (i2) arm's 3, (i3)'s 32 training steps), K1 on the bf16
    # layer-norm scale Composite, K2 and K3 in bf16 at (i)'s panels, K4 at
    # (i3)'s causal softmax
    arms = bf16["i2"]["arms"]
    runs_i = {"i1": bf16["i1"]["launches"], "i2_plain": arms[False]["launches"], "i2_remat": arms[True]["launches"],
              "i3": bf16["i3"]["launches"]}
    path_i = {k: {w: r[0][k] + r[1][k] for w, r in runs_i.items()} for k in ("K1", "K2", "K3", "K4")}
    i1_ms, i1_plain_ms, i1_bound_ms, i1_bound_by, i1_cold_ms = bf16["i1"]["k1_times"]
    # the bfloat16 Composites' error relative to their output's scale, the
    # float32 ones' (the losses', (i3)'s) absolute, as each is gated
    runs_k1 = (bf16["i1"], arms[False], arms[True])
    k1_bf16 = {"shape": [BATCH, SEQ, D_MODEL], "max_rel_err": max(r["k1_rel"] for r in runs_k1),
               "fp32_max_abs_err": max([r["k1_err"] for r in runs_k1] + [bf16["i3"]["k1_err"]]),
               "ms": i1_ms, "cold_ms": i1_cold_ms, "plain_ms": i1_plain_ms, "bound_ms": i1_bound_ms,
               "bound_by": i1_bound_by, "library_ms": None}
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_bf16["fp32_max_abs_err"])
    # path (j): (j1)'s launches in its 3 counted steps, K1 on its Composites,
    # K4 at its (500, 10) log-softmax
    j1 = convnet["j1"]
    path_j = {k: j1["launches"][0][k] + j1["launches"][1][k] for k in ("K1", "K4")}
    k1["max_abs_err"] = max([k1["max_abs_err"]] + [row["max_abs_err"] for row in j1["composites"]])
    k4_j = {key: j1["k4"][key] for key in ("max_abs_err", "ms", "cold_ms", "plain_ms", "bound_ms", "library_ms")}
    attention_i = {k: {"x".join(map(str, shape)): r[k] for shape, r in bf16["attention"].items()} for k in ("K2", "K3")}
    # path (k): (k1)'s launches in its 3 counted steps, K4 at its (T B, C)
    # log-softmax; each loop kernel's launches in (k2)'s or (k3)'s 3 counted
    # calls, its checks and times
    k1_run, loops = ctc_random["k1"], ctc_random["loops"]
    path_k = {k: k1_run["launches"][k] + k1_run["replayed"][k] for k in ("K1", "K4")}
    k4_k = {key: k1_run["k4"][key] for key in ("max_abs_err", "ms", "cold_ms", "plain_ms", "bound_ms", "library_ms")}
    k_runs = {"TG": ctc_random["k2"], "TP": ctc_random["k2"], "TB": ctc_random["k2"], "TM": ctc_random["k3"]}
    loop_names = {"TG": "TG gamma (no TPU kernel)", "TP": "TP Poisson (no TPU kernel)",
                  "TB": "TB binomial (no TPU kernel)", "TM": "TM MRG31k3p streams (no TPU kernel)"}
    loop_lines = []
    for name, run in k_runs.items():
        line = kernel_line(loop_names[name], "cuda", RL_SOURCE, RL_REPLACES[name], name,
                           ((run["launches"], run["replayed"]), {name: None}), loops[name])
        line.update(mismatches=loops[name]["mismatches"], rows=loops[name]["rows"],
                    **{k: v for k, v in loops[name].items() if k.startswith("torch_")})
        loop_lines.append(line)
    # path (l): each run's launches in its counted calls or steps; K1 on
    # (l1)'s and (l2)'s Composites and (l3)'s fp16 ones; K2 and K3 at (l5)'s panels
    runs_l = {w: path_l["l1"][w]["launches"] for w in ("l1a", "l1b", "l1c", "l1d")}
    runs_l.update({w: path_l[w]["launches"] for w in ("l2", "l3", "l4")})
    path_l_launches = {k: {w: r[0][k] + r[1][k] for w, r in runs_l.items()} for k in ("K1", "K2", "K3", "K4")}
    # (l1)'s and (l2)'s Composites compute in bf16 (gated by BF16_REL of the scale): kept apart
    k1["max_abs_err"] = max(k1["max_abs_err"], path_l["l3"]["k1_err"])
    k1_l_16 = max(row["max_abs_err"] for row in path_l["l1"]["composites"] + path_l["l2"]["composites"])
    attention_l_rows = {k: {f"{dt} {'x'.join(map(str, shape))}": r[k] for (dt, shape), r in path_l["l5"].items()}
                        for k in ("K2", "K3")}
    kernels = [
        dict(kernel_line("K1 fused elemwise Composite", "triton", K1_SOURCE, K1_REPLACES, "K1", train, k1),
             cold_ms=k1_times[4], **k1_adamw, path_e_launches=path_e["K1"], path_f_launches=path_f["K1"],
             path_g_launches=path_g["K1"], path_h_launches=path_h["K1"], path_i_launches=path_i["K1"],
             path_i_bf16=k1_bf16, path_j_launches=path_j["K1"], path_k_launches=path_k["K1"],
             path_l_launches=path_l_launches["K1"], path_l_fp16_max_rel_err=path_l["l3"]["k1_rel"],
             path_l_bf16_max_abs_err=k1_l_16),
        dict(kernel_line("K2 flash attention forward", "cuda", K2_SOURCE, K2_REPLACES, "K2", train, k2),
             adamw_launches=adamw["launches"]["K2"], path_i_launches=path_i["K2"], path_i_bf16=attention_i["K2"],
             path_l_launches=path_l_launches["K2"], path_l=attention_l_rows["K2"]),
        dict(k3_line, adamw_launches=adamw["launches"]["K3"], path_i_launches=path_i["K3"],
             path_i_bf16=attention_i["K3"], path_l_launches=path_l_launches["K3"], path_l=attention_l_rows["K3"]),
        dict(kernel_line("K4 row log-softmax", "cuda", K4_SOURCE, K4_REPLACES, "K4", (lr["launches"], lr["traced"]),
                         dict(lr["K4"], max_abs_err=max([lr["K4"]["max_abs_err"], k4_f["max_abs_err"]]
                                                        + [r["max_abs_err"] for r in k4_e.values()]
                                                        + [r["max_abs_err"] for r in k4_g.values()]
                                                        + [k4_j["max_abs_err"]]))),
             path_e_launches=path_e["K4"], path_e=k4_e, path_f_launches=path_f["K4"], path_f=k4_f,
             path_g_launches=path_g["K4"], path_g=k4_g, path_h_launches=path_h["K4"], path_i_launches=path_i["K4"],
             path_i=bf16["k4"], path_j_launches=path_j["K4"], path_j=k4_j, path_k_launches=path_k["K4"],
             path_k=k4_k, path_l_launches=path_l_launches["K4"]),
        kernel_line("K5 CSR SpMV (narrow rhs)", "cuda", K567_SOURCE, K5_REPLACES, "K5",
                    (glm["launches"], glm["traced"]), k5),
        kernel_line("K6 CSR SpMM (wide rhs)", "cuda", K567_SOURCE, K6_REPLACES, "K6", (lr["launches"], lr["traced"]),
                    k6),
        kernel_line("K7 CSR SDDMM", "cuda", K567_SOURCE, K7_REPLACES, "K7",
                    (grad_values["launches"], grad_values["traced"]), k7),
        dict(tf_line, path_k_launches=ctc_random["k2"]["launches"]["TF"] + ctc_random["k2"]["replayed"]["TF"]),
        *loop_lines,
    ]
    stop_cpu_references()
    log(f"chip_smoke: every phase passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
