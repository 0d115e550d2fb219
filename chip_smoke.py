#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``bigdl_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It needs CUDA and exits non-zero without it.  Phases, each printed as
it runs; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``); f32
   matmuls are set to full f32 (no TF32);
2. build: ``nvcc`` compiles every kernel under ``bigdl_tpu_torch/csrc``
   for sm_90a, all sources at once; ``cuobjdump -sass`` must find bf16
   ``HMMA`` (tensor-core) instructions in every bf16 instantiation of the
   flash forward and backward kernels and of the kxk and 1x1 convs, and
   none in the f32 ones, and ``ptxas`` must report no spills for the
   bf16 ones (registers printed by D or by the 1x1's VEC);
3. kernels: each kernel against its plain PyTorch version on the card
   at the main path's shapes, with the max abs error, the kernel's
   time, the plain version's time, its bound, and a PyTorch library
   call's time where one computes the same function; the flash forward
   also in bf16 at the training shape (B=16, H=8, T=512, D=64, causal)
   and at B=2, T=4096, timed there beside the forward of
   ``scaled_dot_product_attention`` with TFLOP/s and share of the
   bound; the paged decode also with one slot at length 511 and the
   others at 0, with a bucket of width 1 and with a bf16 cache at
   Dh=128, and timed a call and on the device; every case run twice and
   bit-equal;
4. serving path: the flagship TransformerLM (vocab 8192, dim 512, 8
   heads, 8 layers, max_len 512, random f32 weights from a seed) served
   by ``LMEngine`` with the flash prefill kernel and the paged decode
   kernel: 12 requests, prompts of 100-400 tokens, 32 new tokens each,
   temperature 0.  Every generated token is checked against a full
   forward of the model over the same tokens;
5. where the decode step's time goes: ``torch.profiler`` over ten
   steps of a full batch, device busy share, the top kernels and the
   port's own below them;
6. conv_bn kernels: ``conv_bn_1x1`` and ``conv_bn_kxk`` against their
   plain version at every distinct fused site of ResNet-50 (224x224,
   batch 32, bf16; the sites are read from the model), three f32 cases,
   two bf16 kxk cases whose C is not a multiple of 8, the
   ``scripts/kxk_probe.py`` shape and three bf16 1x1 cases (HW = 49 at
   C = 64, HW = 30, and C = 20, which goes to the kxk kernel), with the
   errors, a run-to-run bit-equality check of the statistics, and per
   shape the kernel's time (a call, and on the device alone), the plain
   version's, ``F.conv2d`` alone (a conv without statistics, the
   library yardstick) and the bound, and at each bf16 1x1 the bf16 kxk
   kernel at k = 1 on the device (the 1x1's yardstick), each also
   summed over one training step's 36 and 16 launches; on x = 0 the
   statistics must come out exact;
7. training path: ResNet-50 (1000 classes, random weights from seed
   0, the zero gamma of each block's last BN drawn anew from seed 2,
   the LogSoftMax tail dropped for ``CrossEntropyCriterion``)
   trained by ``LocalOptimizer`` with ``SGD(learningrate=0.1)`` and
   the bf16 compute policy on synthetic 224x224 data, batch 32: the
   standard arm, then the fused arm (``fuse_conv_bn``), each from the
   same weights and data.  Every loss must be finite, the two arms'
   losses must agree at every step, and the fused arm must launch
   ``conv_bn_1x1`` 36 and ``conv_bn_kxk`` 16 times per step (the
   standard arm neither);
8. where the fused training step's time goes: ``torch.profiler`` over
   two steps, device busy share, the top kernels and the top host ops;
10. flash backward kernels: ``flash_bwd_dq`` and ``flash_bwd_dkv``
    against their plain versions at the training shape (B=16, H=8,
    T=512, D=64, causal; bf16 and f32), the long-context shape of
    ``scripts/attn_ab.py`` (B=2, T=4096, bf16), a non-causal
    cross-length case, a ragged causal case (T=131, D=32) and D=128,
    each in f32 and bf16, each run twice and bit-equal; at the training shape (bf16 and f32)
    and at the long-context shape (bf16) the kernels' times, achieved
    TFLOP/s (6·D and 8·D FLOPs per causal pair) and share of their
    bounds, the bounds, and the backward of
    ``scaled_dot_product_attention`` (dq, dk and dv together) beside
    their sum plus δ; the plain versions' times at the training shape;
11. transformer training: the flagship TransformerLM (vocab 8192, dim
    512, 8 heads, 8 layers, random weights from seed 0) at batch 16,
    T=512 with ``CrossEntropyCriterion`` and ``SGD(learningrate=1e-3)``,
    in a reference arm and a kernel arm (``attn_impl="kernel"``) from
    the same weights and int32 tokens: (a) one step's f32 gradient of
    every parameter, kernel arm within 1e-4 relative L2 of the
    reference arm, ``wq/wk/wv`` nonzero; then two steps of the kernel
    arm at B=2, T=4096 with ``remat=True`` (16/8/8 launches a step),
    and two more of it under ``torch.profiler`` (device busy, kernels);
    (b) 1 + 5 ``LocalOptimizer`` steps per arm under the bf16 policy,
    every loss finite and the arms within 1e-2 at every step, the
    kernel arm launching ``flash_fwd``, ``flash_bwd_dq`` and
    ``flash_bwd_dkv`` 8 times each per step (the reference arm none);
12. where the kernel arm's step goes: ``torch.profiler`` over two
    steps, as phase 8;
13. the PTB language model (``bench.py:414-426``: vocab 10000, embed
    128, one LSTM of 256, random weights from seed 0) trained one epoch
    in f32 by ``LocalOptimizer`` with ``SGD(learningrate=0.1)`` and the
    L2 clip of 5.0, over ``synthetic_ptb_stream``'s 20000 tokens in
    BPTT windows of 20 over 64 streams (15 steps): every loss finite
    and within 1e-4 relative of the same run on the CPU (same weights,
    same shuffle), the perplexity lower after the epoch than before, no
    kernel of ``csrc/`` launched; a ``Recurrent(GRU(128, 256))`` forward
    and its input gradient within 1e-4 relative L2 of the CPU's; the
    steady step's ms and tokens/s, then two steps under
    ``torch.profiler`` (device busy share, host ops), as phase 8;
14. LeNet-5 with validation: ``train_lenet``'s recipe through the
    ``Optimizer`` factory on synthetic MNIST (2048 train, 2048 test,
    batch 128, lr 0.1, 2 epochs, ``Top1Accuracy`` and ``Loss`` every
    epoch): the last validation's Top1 at least 0.99, the first 3 losses
    within 1e-4 relative of a CPU run's, and ``evaluate_dataset`` on the
    card and on the CPU from the final weights giving equal Top1 counts
    and Loss values within 1e-5; the steady step's ms and images/s;
15. ResNet-50 from an image folder through ``DistriOptimizer``: a
    folder of BMPs written from seed 0 (8 classes, 32 train and 8 val
    images each, 240x300 to 300x240 pixels, a class pattern plus
    noise); (a) the entry point, ``bigdl_tpu_torch.models.resnet.main
    (["-f", DIR, "--depth", "50", "-b", "32", "-e", "2",
    "--checkpoint", CK])``: ResNet-50 at full width, 224x224, f32, the
    reference recipe, world 1 on NCCL, 8 steps an epoch; every loss
    finite, Top1 and Top5 logged each epoch, neval 17, two checkpoints
    that pass ``verify_checkpoint``, the last loading into a CPU model
    bit-equal to the trained one; (b) the retry: 64 synthetic 224x224
    images, no shuffle, batch 32, 3 epochs, a RuntimeError at the first
    step of epoch 2 through ``_put_batch``: one reload, neval 7, weights
    and BN state bit-equal to an uninterrupted run; (c) phase 7's
    ResNet-50 for 3 steps by ``DistriOptimizer`` at world 1 and by
    ``LocalOptimizer``: f32 with the f32 wire, losses and params within
    1e-5 relative; fused in bf16 with the bf16 wire, losses within
    1e-2, ``conv_bn_1x1`` and ``conv_bn_kxk`` launched 36 and 16 times a
    step; (b) and (c) with cuDNN deterministic; (d) timing lines, no
    limits: the entry point's median step ms and images/s, the host
    decode ms a batch, how often the step waited on the prefetch queue,
    the f32 comparison of (c) again on cuDNN's default algorithms, and
    the same 8 steps with the batches copied from pageable and from
    pinned memory (pinned, pageable, pageable, pinned), each with the
    card's name and power limit; the process group is destroyed at the
    end;
16. BASELINE config 3, Inception and VGG through the Caffe files, no
    kernel of ``csrc/`` launched: (a) ``python -m
    bigdl_tpu_torch.models.inception -f DIR --version v1 -b 32 -e 1
    --checkpoint CK`` in a child process over phase 15's folder: every
    loss finite, Top1 and Top5 logged, one verified checkpoint, the
    step ms and images/s; then ``--version v2 -n 64 -b 32`` on the
    synthetic task, every loss finite; (b) ``build_inception_v1(1000,
    has_dropout=False)`` and ``build_vgg16(1000)`` (random weights from
    seed 0, the LogSoftMax dropped) through ``to_graph`` ->
    ``CaffePersister`` -> ``CaffeLoader`` on the card: the loaded
    forward at batch 8 within 1e-5 (relative to max |y|) of the
    exported graph's and at batch 2 within 3e-5 of the card machine's
    CPU's, the files' sizes and the save and load seconds, and the same
    CPU comparison with TF32 on as a control; (c) each
    loaded graph trained by ``DistriOptimizer`` at world 1, f32 on the
    f32 wire, batch 32, 1 + 5 steps (the Inception recipe, or SGD 0.01
    with momentum 0.9): losses finite, step ms, images/s, peak memory,
    two profiled steps; Inception-v1's Sequential against its loaded
    Graph (step ms, in turns); Inception-v1's first 3 losses at batch 4
    within 2.5e-7 relative of ``LocalOptimizer`` on the CPU from the same
    files, cuDNN deterministic, and the card's run again with TF32 on as
    a control; (d) one more step of the loaded
    Inception-v1 with a checkpoint, which ``load_latest_checkpoint``
    and its spec reload on the CPU bit-equal;
17. the serving tier over HTTP at full width, no kernel of its own: (a)
    phase 4's flagship in ``LMEngine`` (``start()``) and ResNet-50
    (1000 classes, eval, f32, seed 0) in ``ClassifierEngine`` (batch 8)
    behind one ``ServingServer(port=0)``: phase 4's 12 prompts from 12
    concurrent ``/v1/generate`` clients (every token within 1e-3 of the
    top logit of a full forward; ``flash_fwd`` and ``paged_decode``
    launched on that path), then 8 single-image ``/v1/classify``
    clients (outputs within 1e-5 of ``resnet(x)`` at batch 8, argmax
    equal), ``/stats`` and ``/healthz`` well formed; TTFT, e2e and HTTP
    ms, tokens/s, images/s; (c) ``/admin/drain`` with deadline 0 once
    all 12 requests are in the engine and 40 tokens decoded: each
    client gets its whole answer or a 503 + ``Retry-After`` whose
    handoff equals the drain's record and carries its trace header,
    each handoff replayed once (``HandoffLedger``) on a second engine
    with the same weights, the joined tokens within 1e-3 of the top
    logit; (b) ``int8_mm`` (``torch._int_mm`` on padded operands)
    bit-equal to its float64 plain version at the decode shapes and
    three ResNet-50 conv shapes, with what ``_int_mm`` refuses
    unpadded; ``LMEngine(int8=True)`` serving the 12 prompts (tokens
    in the vocab, ``paged_decode`` launched), its agreement with the
    float tokens, decode step and weight bytes; ``ClassifierEngine``
    float and int8 on ResNet-50 (finite, top-1 agreement, images/s);
    (d) ``swap_weights`` to seed 1's weights (a numpy tree) while four
    requests decode: they finish whole, the eight admitted after it
    meet the 1e-3 gate on the new weights, ``/healthz`` reports v1;
    (e) a queue of capacity 1 nobody pumps answers 503 +
    ``Retry-After``; (f) BASELINE config 5: ``DLClassifier`` over a
    dict DataFrame, ``bench.py:472-492``'s 4096 x 64 frame and MLP
    (batch 256, 2 epochs, lr 1.0) and LeNet-5 on flat synthetic MNIST
    rows (``feature_size=[28, 28]``), each on the card and on the CPU:
    training accuracy above 0.9, the fitted NLL and weights against
    the CPU's, rows/s through fit + transform;
18. the optim methods, f32 throughout, no kernel of their own
    (``phase_optim``, callable alone): (a) ``Adam``, ``Adagrad``,
    ``Adadelta``, ``Adamax``, ``RMSprop``, ``Ftrl``, ``LBFGS``,
    ``LarsSGD`` and ``SGD`` under ``Step``, ``Exponential`` and
    ``EpochDecay``, 3 steps each at the flagship's parameter shapes (133
    tensors, 34M values) on the card and on the CPU from the same
    seeded parameters, quadratic gradients and state: what |card - CPU|
    exceeds one ulp of p by, over the largest |Δp|, within 1e-5; ms a
    step, LBFGS's peak memory; (b) NCF as
    ``examples/recommendation/ncf_train.py`` runs it, at ml-1m's id
    ranges (6040 users, 3706 items; the synthetic latent-factor
    positives, 4 negatives each, 573800 rows), the example's widths,
    ``Adam(1e-3)``, batch 256, one epoch through ``LocalOptimizer``
    with ``Trigger.or_(max_epoch(1), max_iteration(3000))``: the first
    20 losses within 1e-4 relative of the CPU's, HitRatio@10 above 0.10
    and NDCG@10 above 0.045 (leave-one-out, 99 negatives), step ms and
    rows/s; (c) the flagship (B=16, T=512, kernel attention) in f32 with
    ``Adam(1e-3)`` under ``Step(2, 0.5)`` and its token embedding frozen,
    1 + 5 steps through ``LocalOptimizer``, then through
    ``DistriOptimizer`` (world 1, NCCL, f32 wire), then with ``SGD``:
    every loss finite, the embedding bit-equal, 8 launches of each
    flash kernel a step, Distri within 1e-5 of Local (cuDNN
    deterministic), step ms beside phase 11's; (d) ``train_autoencoder``
    (``Adagrad(0.01)``, batch 128, one epoch of synthetic MNIST) on the
    card and on the CPU: the loss falls, the first 5 losses within 1e-4;
    (e) ``LookupTable``, ``LSTM``, ``SpatialConvolution`` and ``Linear``,
    each with an ``L1L2Regularizer``, 3 ``Adam`` steps on the card and
    on the CPU: losses and ``regularization_loss`` within 1e-5;
19. the text CNN and the rest of the criterions, layers and table ops,
    f32, TF32 off, cuDNN deterministic, no kernel of ``csrc/``
    (``phase_text_cnn``, callable alone after ``phase_device()``): (a)
    ``bigdl_tpu_torch.examples.train_text_cnn.main`` at the JAX
    example's defaults (``-b 128 -e 3 --learning-rate 0.05 --doc-len
    32``: the ``synthetic_news20(1536, 4)`` stand-in, embed 32, 64
    filters of width 5, ``Adam``, Top1 validation each epoch) on the
    card and on the CPU: each of the first 20 losses within 1e-6 of the
    CPU's, over the CPU's first loss (beside the gaps relative to each
    loss and those of the CPU run on one thread, a control), the last
    Top1 at least 0.9 and within 0.02 of the CPU's; step ms (median
    and range over steps 2-end) and tokens/s; (b) ``build_text_cnn`` at
    the news20 shape (vocab 20001, 20 classes, 128 tokens) on ids from a
    seeded ``torch.Generator``, 50 ``Adam`` steps of batch 128 through
    ``LocalOptimizer``, for speed only: step ms, tokens/s, peak memory
    and two profiled steps; (c) (a)'s model served by ``udf_predict``'s
    ``make_predict_udf`` and by ``DLClassifierModel.transform`` over
    the 1536 documents: the class ids of both equal and equal to the
    CPU model's on the same weights, the log-probabilities within 1e-5
    (times the largest magnitude above 1), rows/s of each form; (d)
    every class the slice ported (the criterions, layers and table ops,
    ``ConvLSTMPeephole`` at B=4, T=8, 16->32 channels, 32x32, SAME
    ``SpatialConvolution`` at strides 1 and 2) at about 1e5 elements an
    input, forward and backward on the card and on the CPU from the same
    weights: outputs, input and parameter gradients within 1e-5 of the
    largest magnitude beyond one ulp (3e-5 for the convs, cuDNN's f32
    weight gradient), integer outputs equal; the worst gap printed per
    family, and each tensor's above 1e-6 with the card's and the CPU's
    gaps to the same case in f64 on the CPU;
20. the flagship behind the router (``BIGDL_TORCH_REQTRACE_SAMPLE=1``
    for this phase only): three ``LMEngine`` replicas of phase 4's
    flagship (max_batch 8, page 16, the paged decode kernel), each on
    its own weights object, in this process behind ``Router`` and
    ``RouterServer``: (a) 24 requests from 12 client threads over HTTP,
    prompts of 100-400 tokens, 32 new tokens, four sessions of three
    turns: every token within 1e-3 of the top logit of the serving
    replica's model, affinity hits >= 8, ``flash_fwd`` and
    ``paged_decode`` launched; per-replica counts, client e2e p50/p99,
    the router's share of each request (client e2e - engine e2e) and
    tokens/s against phase 4; controls: the 12 single prompts through
    the router, plain and under ``torch.profiler`` (the device's busy
    share), and straight into one engine, each with every replica's
    decode step and its thread's CPU time a step; then the 12 through
    a router over one engine with ``decode_attn="fused"``, every token
    within 1e-3 of the top logit and the decode kernel not launched;
    (b) ``begin_drain`` at deadline 0 on a session's replica while four
    of its requests decode: each handoff claimed and replayed once,
    every request answered whole and equal to (a)'s tokens, the drain's
    ms; (c) one replica's queue closed:
    requests retry onto the others within the budget; then a budget of
    0 and the other queues held full: every request shed 503 +
    ``Retry-After``; the retry and shed counters equal what the clients
    saw; (d) rollout: a perturbed flagship v1 published and swapped in
    by the canary's ``CheckpointWatcher``, promoted by
    ``CanaryController`` on ``divergence_probe``; v2 with one byte of
    its ``.npz`` flipped after the manifest, refused and counted; v3 on
    other weights, rolled back (drain, revert, undrain) while clients
    send, none dropped; the swap ms and the poll-to-swap ms; (e) every
    kept trace's queue + prefill + preempt + decode within 1e-6 s of
    its engine's e2e, ``ObsServer``'s ``/trace?request=ID`` and
    ``/metrics`` (parsed, the router, rollout and serving families, an
    exemplar), an undeclared ``bigdl_`` family refused in strict mode,
    the scrape's ms;
21. BigDL's ImageNet recipe through the image pipeline and the
    checkpoint layer (``phase_image_pipeline``, callable alone after
    ``phase_device()`` and ``phase_build()``): (a) phase 15's folder
    decoded by ``read_image`` into ``DistributedImageFrame.read`` at
    world 1, ``RandomAspectScale([256, 288])`` -> ``RandomCrop(224,
    224)`` -> ``RandomTransformer(HFlip(), 0.5)`` -> ``ColorJitter()``
    -> ``ChannelNormalize`` -> ``MatToTensor`` -> ``to_dataset(32)``;
    ResNet-50 (8 classes, seed 0) fused, bf16 compute, through
    ``DistriOptimizer`` on NCCL with SGD and momentum for 2 epochs (16
    steps), background checkpoints every 4 iterations (2 kept), a
    ``TrainSummary`` with "Parameters" histograms every 8 and a
    ``ValidationSummary`` of Top1 on the val frame (``Resize(256, 256)``
    -> ``CenterCrop(224, 224)`` -> ``ChannelNormalize`` ->
    ``MatToTensor``): 36 ``conv_bn_1x1`` and 16 ``conv_bn_kxk`` launches
    a step, every loss finite, the first loss within phase 7's 1e-2 of
    an unfused run's on the same batch, every checkpoint verified
    against its manifest as it lands, the event file's "Loss" scalars
    equal to f32 of each step's loss bit for bit, one histogram a
    parameter leaf a trigger; step ms, images/s, host decode and
    transform ms a batch, then two profiled steps (busy share); (d) the
    trained model through ``save_module(.bigdl)`` and ``load_module``
    back onto the card, parameters and state bit-equal, and
    ``predict_image`` over the val frame within 1e-5 of the model's
    forward, Top1; with cuDNN deterministic: (b) one epoch with
    background and with synchronous writes, weights and every
    checkpoint array bit-equal, the snapshot, write and step ms; then
    the directory removed under a background write: the next trigger
    raises ``CheckpointWriteError`` and
    ``bigdl_checkpoint_write_failures_total`` reads 1; (c)
    ``BIGDL_TORCH_FAULT_PLAN="step:6:raise,ckpt:2:corrupt"`` (shuffle
    off, checkpoints every 2): the corrupted second checkpoint fails
    verification, the retry loads the first, the run ends bit-equal to
    an uninterrupted one; ``step:3:nan_grad``: the step skipped,
    ``nonfinite_skips`` and the summary's "NonFiniteSkips" 1; (e) the
    JAX stream tests' MLP on ``StreamDataSet(SyntheticStream(16, 4,
    seed 0))`` through ``DistriOptimizer`` on the card, a 16-record
    buffer, background checkpoints every 5 and ``step:8:raise``: the
    offset 12 x 32, the retry replaying from the checkpoint's offset,
    weights bit-equal to an uninterrupted run, the producer pushed back
    (the depth gauge and the waits printed);
22. what ``DistriOptimizer`` lacked (``phase_distri_resilience``,
    callable alone after ``phase_device()`` and ``phase_build()``), at
    world 1 on NCCL with cuDNN deterministic: (a) phase 7's fused
    ResNet-50 (bf16, batch 32) 8 steps through ``DistriOptimizer`` with
    SGD and momentum, first on the f32 wire in one bucket, then with
    ``wire_dtype="int8"``, ``wire_ef=True``, ``overlap_bucket_mb=25``,
    ``BIGDL_TORCH_HEALTH_EVERY=4``, the tracer and the obs server on an
    ephemeral port: the weights bit-equal to the f32 run (at world 1
    the wire is the identity and the one-rank shard-major layout the
    flat one), 36 ``conv_bn_1x1`` and 16 ``conv_bn_kxk`` launches a
    step (counted from 0 around this run), each health report's summed
    grad_sq within 1e-4 relative of the step's pre-clip gradient's
    squared norm taken in f64 in the phase, ``/healthz`` at step 8 and
    ``"stalled"`` after 1 s idle past ``BIGDL_TORCH_HANG_TIMEOUT=0.5``,
    the step spans of step 8 in the tracer's ring; step ms and images/s
    with all of it on and off, the runtime profile's p50s, the health
    report's ms, peak memory; (b) ``parallel.wire.quantize`` /
    ``dequantize`` of the padded flat gradient in bf16, int8, fp8_e4m3
    and fp8_e5m2 at block 512: payloads and scales bit-equal to the
    card machine's CPU, the int8 error within each block's amax / 254,
    their ms on the device (25 runs), each wire's bytes a rank a step
    at worlds 2 and 8 from ``obs/collectives`` against f32; (c) the
    tests' two-rank worker (``tests/torch_port_distri_worker.py``,
    ``ckpt``) checkpoints the small model at world 2 over gloo on the
    CPU (the int8 wire, EF, two buckets); the card resumes it at world
    1 through ``restore_latest``: the re-laid velocity bit-equal to the
    un-permuted, re-padded vector, ``wire_ef`` reset to zeros, epoch
    2's 4 steps within 1e-5 of the CPU's resume; (d) a child process
    trains LeNet-5 (1024 synthetic MNIST images, batch 128) on the card
    through ``DistriOptimizer`` with checkpoints each epoch and takes a
    SIGTERM after step 3: it exits 170 with an intact emergency
    checkpoint, and ``restore_latest`` in a second child ends bit-equal
    to an uninterrupted child;
23. Wide & Deep, the tree-LSTM, AlexNet and item 16's layers
    (``phase_item16``, callable alone after ``phase_device()``; (e)
    needs ``phase_build()``), each against the card machine's CPU: (a)
    Wide & Deep at ``bench.py``'s ``wide_and_deep`` widths (batch 256,
    f32) 1 + 20 steps through ``LocalOptimizer`` and through
    ``DistriOptimizer`` (world 1, NCCL), profiled, then the example's
    ``main --distributed -e 2``: losses within 1e-4 of the CPU's,
    Distri within 1e-5 of Local, train-set Top1 within 0.01; (b) the
    tree-LSTM example at its defaults: the losses every 50 steps within
    1e-4, the root accuracy equal, ms and kernels a step; (c)
    AlexNet-OWT at 227 px, batch 32, bf16, 1 + 5 steps, profiled, peak
    memory; its first 3 f32 losses at batch 4 (cuDNN deterministic, no
    dropout) within 3e-5 of the CPU's and, as the control, over that
    with TF32 on; (d) ``ITEM16_CASES``: every class of item 16 and
    ``Remat`` forward and backward at ~1e5 elements, card against CPU
    and both against the CPU in f64 (3e-5 for the convs and the
    volumetric family, 1e-5 for the rest); (e) LeNet-5 with
    ``nan_grad`` at step 3 and health every 4 in both trainers: reports
    at steps 3 and 4, 2 fetches, the offenders and the counter equal to
    the CPU's; then phase 22 (a)'s "on" run with the fix's deferred
    stats and without them in alternate blocks of 4 steps, the step
    with them no slower than 3% or twice the difference's standard
    error; (f) no ``csrc/`` kernel launched in (a)-(e) but in (e)'s run
    of phase 22 (a)'s path (36 / 16 a step);
24. the flash kernels' ``seq_offset``, the tuner and sequence
    parallelism (``phase_seq_tuner``, callable alone after
    ``phase_device()``): (a) rows 1-3 at B=2, H=8, D=64, causal, f32
    and bf16, (Tq, Tk) in (512, 512), (512, 1024), (200, 333) at
    offsets 0, 37, 64 and Tk - Tq against their plain versions (and the
    forward against ``_reference_attention``) at phase 3's and 10's
    limits, each timed at (512, 1024) at offsets 0 and 512 beside its
    bound; (b) the tuner on with measurement into a fresh cache:
    attention at phase 3's and 10's bf16 shapes, conv_bn at three fused
    ResNet-50 sites, the paged decode at phase 4's shape and bucket,
    int8_mm at phase 17's shapes; every decision printed (candidates'
    ms, static, winner, the regress verdict), each winner within the
    static candidate's time times the tolerance; a second pass after
    ``reset()`` all hits with no measurement; a corrupt cache file all
    static and left as it was; (c) ``train_long_lm.main`` at the
    flagship's width (B=2, T=4096, remat, bf16, 4 steps) plain, with
    Ulysses and the tuner off, and with the tuner on: plain and
    Ulysses-off losses within 1e-2, the loss falling, rows 1-3 16/8/8
    launches a step if the tuner chose the kernel (0/0/0 if not), step
    ms, tokens/s and peak memory; then the tuner on and off in
    alternate blocks of one run, the ratio with two standard errors;
    (d) ``RingMultiHeadAttention`` at world 1 against the plain module,
    f32, T=4096, within 1e-5;
25. tensor parallelism, TP-sharded decode, the pipeline and MoE
    (``phase_tp_moe``, callable alone after ``phase_device()`` and
    ``phase_build()``): (a) the paged decode kernel at a TP rank's
    shape (B=8, H=4, Dh=64, P=16, f32) against its plain version at
    phase 3's limit, bit-equal run to run, timed beside its bound; then
    the flagship (phase 4's weights) served by ``LMEngine(tp=2,
    decode_attn="kernel")`` as two rank processes on the one card over
    gloo (``chip_smoke.py --tp-rank``, after phase 2's build, which
    they load), rank 0 leading and rank 1 following, phase 4's 12
    prompts and 32 new tokens: every token within 1e-3 of the top
    logit of a dense forward, the exact matches with phase 4's tokens,
    the flash prefill and paged decode launches of each rank (8 decode
    launches a step), the ``serve_tp_psum`` bytes equal to their
    formula, tokens/s beside phase 4's; (b) ``shard_params`` and the TP
    forward and backward of the flagship at world 1 (``attn_impl=
    "kernel"``, f32, B=4, T=512) against the dense model: logits and
    every parameter gradient within 1e-5 of the largest, rows 1-3 8
    launches each; (c) ``MoE`` (D=512, hidden 2048, 8 experts, top-2,
    capacity 1.25, B=8, T=512, f32) against tokens routed to their
    experts by index: output and aux loss within 1e-4, the input and
    parameter gradients within 1e-4 of their largest in f64 (printed in
    f32 too, where the ReLU's kink lets the two orders of summation
    differ by a token's share), forward + backward ms; and
    ``pipelined`` at world 1 against the stages in sequence (1e-5);
26. control flow and the model front ends (``phase_front_ends``), no
    kernel of ``csrc/``: (a) VGG-16 at full width (seed 0, LogSoftMax
    kept) through ``to_graph`` -> ``TensorflowSaver`` ->
    ``TensorflowLoader`` on the card, GraphDef nodes, bytes and
    seconds, the loaded forward at batch 8 within 1e-5 of the exported
    graph's and at batch 2 within 3e-5 of the CPU's (TF32 on printed as
    the control); (b) ``TFTrainingSession(...).train`` of that graph
    through ``LocalOptimizer`` (ClassNLLCriterion, SGD 0.01 momentum
    0.9, batch 32, 1 + 5 steps, cuDNN deterministic) beside the source
    ``Sequential`` with its Dropout off: every loss finite and within
    1e-5 relative of the source's, step ms, images/s and peak memory of
    both; (c) the weights as a Torch7 ``nn.Sequential`` through
    ``save_t7`` -> ``load_t7`` -> ``load_torch_module``, batch 8 within
    1e-5; (d) VGG-16 as a Keras-1.2.2 JSON config through
    ``model_from_json`` and ``set_weights``, its softmax within 1e-5 of
    ``exp`` of the source's at batch 8, then ``compile("sgd",
    "categorical_crossentropy")`` and ``fit`` over 6 batches of 32;
    (e) a TF Switch/Merge conditional and a while frame imported on the
    card and on the CPU, forward and input gradient within 1e-5 both
    ways, ``IfElse`` and ``WhileLoop`` forward, ``WhileLoop``'s refused
    backward, the ``DynamicGraph``'s forward at ``max_iterations`` 32
    against a body that stops after 3, timed beside 3 plain iterations;
    (f) ``mnist_cnn``, ``finetune_frozen_graph`` and
    ``train_from_tf_pipeline`` in child processes at their defaults, 2
    epochs: every loss finite, the accuracy each returns, seconds;
27. the fleet observability and control plane (``phase_fleet``): (a)
    phase 22's fused ResNet-50 (bf16, batch 32, 224x224, 4 batches an
    epoch, SGD momentum 0.9, f32 wire, cuDNN deterministic, TF32 off,
    each loss read before the next step) through ``DistriOptimizer`` at
    world 1, 14 steps with a checkpoint every 8,
    in a ``python -c`` child under ``python -m
    bigdl_tpu_torch.resilience.supervisor --autoscale``: attempt 0
    sends itself SIGTERM at step 5 and exits 170 with its emergency
    checkpoint, attempt 1 resumes through ``restore_latest`` and exits
    1 after step 10, attempt 2 resumes from step 8's checkpoint and
    ends; the supervisor exits 0 with 1 preempted and 1 transient
    restart, the weights, BN state and momentum bit-equal to an
    uninterrupted child's (run beside it; it also times the step with
    the profiler at 100 Hz and off, alternate 4-step blocks), 36/16 conv_bn launches
    a step in every child; (b) attempt 2 holds at its last step while
    ``/healthz`` (attempt 2, goodput in (0, 1], the profiler's overhead
    within its budget, or back within it in 5 s of skipped samples, the
    alert firing, a bundle), ``/profilez`` (the
    heaviest span-attributed stack under a training span), the alert's
    one bundle (verified, the card's memory in ``runtime.json``),
    ``/debugz`` (a second bundle) and the fleet scrape into the
    retention store are read; (c) the goodput ledger over the attempts'
    shards (rework steps 9-10, the ratio, the unknown seconds), the
    supervisor's backoff record against its policy's delay (50 ms), the
    checkpoints' save and restore seconds, the report CLI (goodput,
    alerts, resilience) and the trace merge (three barrier-aligned child
    shards); (d) the dry-run autoscaler's evaluations (all at the world
    bound, none executed; each ``step_time_s`` sample within 50%, and
    their median within 20%, of the children's step period over the
    steps that sample spans, from their loss reads, printed beside
    their runtime p50, the dispatch-to-loss interval, which ends
    before the step's backward and update do on the card; their
    ``goodput_ratio`` within 0.02 of ``/healthz``'s) and a two-tier rollup whose quantiles are
    bit-identical to the flat merge; (e) the four example scripts ported
    with the fleet plane at their defaults, at once, in child processes;
28. the obs plane at bring-up, the host library, the step profiler and
    the fleet simulator (``phase_obs_native_sim``; (b) runs first, then
    (c) beside (a)): (a) ``Engine.init``
    under ``BIGDL_TORCH_OBS_PORT=0`` and ``BIGDL_TORCH_PROF_HZ=50``:
    ``/healthz`` and ``/metrics`` answer before any model exists; the
    flagship ``LMEngine`` (built with the profiler stopped) leaves a
    ``SamplingProfiler`` running and serves phase 4's 12 requests, the
    tokens equal to phase 4's (served with the plane off), the flash
    forward and paged decode launched as often as in phase 4; a second
    ``init`` under ``BIGDL_TORCH_CHECK_SINGLETON=1`` raises; (b) phase
    27's fused ResNet-50 (bf16, batch 32, 224x224, SGD momentum 0.9,
    cuDNN deterministic, TF32 off, each loss read before the next step)
    through ``LocalOptimizer`` over an f32 ``ArrayDataSet`` of 128
    images (77 MB), 8 steps three ways: with the host library (its
    conv_bn launches count for the kernels line), with
    ``BIGDL_TORCH_NO_NATIVE=1``, and with the library under
    ``BIGDL_TORCH_PROFILE``: batches and losses bit-equal, the batch
    gather timed (in the feed and alone) and the step timed each way,
    36/16 conv_bn launches a step, and the trace file holding 36
    ``conv_bn_1x1`` and 16 ``conv_bn_kxk`` kernels and one
    ``step_dispatch`` region a traced step (steps 2-8); (c) ``python -m
    bigdl_tpu_torch.sim`` in a child process started after (b) and
    run beside (a): the seven builtin scenarios at 200 hosts (seed 0, a
    10 ms partition stall) in seven worker processes, then the 200-host
    aggregation budget and the four serve scenarios, every invariant
    passing; its JSON in the phase's temporary directory;
29. the classic BigDL loop (``phase_classic``): (a) the flagship
    (f32, B=16, T=512, dropout 0) trained 5 steps by hand,
    ``update_output`` -> ``CrossEntropyCriterion`` ``forward``/
    ``backward`` -> ``zero_grad_parameters`` -> ``backward`` ->
    ``update_parameters(1e-3)``, against ``LocalOptimizer`` + ``SGD`` on
    the same weights and batches (each loss and the final weights within
    1e-5 relative), the flash kernels launched 8/8/8 a step (the
    backward runs on the graph the forward kept); its first step's
    gradients against the reference arm's (``LM_GRAD_REL_TOL``), and one
    step with both arms cast to bf16 (``LM_LOSS_TOL``); (b) the fused
    ResNet-50 (f32, batch 32, 224x224, cuDNN deterministic) 3 steps by
    hand against ``LocalOptimizer`` + ``SGD``: 36/16 conv_bn launches a
    step, losses, weights and BN running statistics within 1e-5 (the
    statistics move once a step); (c) ``save_weights`` ->
    ``load_weights`` into a flagship of another seed, logits bit-equal;
    (d) ``tests/test_bigdl_shim.py``'s classic program through
    ``bigdl_torch`` on the card, its losses equal to the same program
    through ``bigdl_tpu_torch``; (e) ``python -m
    bigdl_tpu_torch.analysis.lint`` exits 0, its seconds printed;
30. the fused optimizer update (``phase_fused_update``, callable alone
    after ``phase_device()``): (a) at GPT-2-medium's 389 tensors
    (406,286,336 f32 values), Adam with an L2 clip of 1.0 and the
    guard, each of the kernel's two passes on the device, both with
    their table a call, the plain version's and the
    per-tensor chain's (``_GradClipper``, ``Adam.step``, the guard's
    ``where``, the write-back) a call, beside the 13.0 GB bound; the
    kernel against the plain version (the norm's order of summation
    aside: 1e-5 of each value's step); (b) a ``LocalOptimizer`` with
    Adam on the card: 2 launches a step, each ``step.update`` obs span
    ``fused`` (the tracer on), its 4 losses and weights against the
    per-tensor path's within 1e-5 relative, and a NaN batch skipped with
    p, m, v and ``neval`` kept bit for bit;
31. latent attention and the sigmoid MoE (``phase_mla``, callable
    alone after ``phase_device()``; it returns its kernels-line rows):
    (a) rows 1-3's (192, 128) instantiation at the
    shape of the ``moonlight-16b-a3b.train.t8192`` cell (bf16, B=1,
    H=16, T=8192, causal, scale 1/sqrt(192)) against the plain versions,
    each output within one bf16 ulp of its largest |value| (phases 3
    and 10's limit), bit-equal run to run; each kernel's time on the
    device, TFLOP/s and share of the bound (2(Dqk + Dv), 2(2·Dqk + Dv)
    and 4(Dqk + Dv) FLOPs a causal pair), and the plain versions' times;
    (b) one ``SigmoidMoE`` at Moonlight-16B-A3B's widths (2048, experts
    of 1408, top-6 of 64, 2 shared, experts 8-15 held) on 8192 bf16
    tokens: forward and backward under
    ``torch.cuda.set_sync_debug_mode("error")``, the output within
    ``MOE_REL_TOL`` of ``tests/plain_deepseek_v3.py``'s ``moe`` in f32 on
    the same bf16 values, and every gradient finite; (c)
    ``DeepseekV3LM`` at those widths, a dense layer and 2 MoE layers,
    vocabulary 20,480, trained ``MLA_STEPS`` steps by ``LocalOptimizer``
    (bf16, Adam 3e-4, L2 clip 1.0) on 1 x 8192 tokens with
    ``attn_impl="reference"`` and then ``"kernel"`` from the same
    weights: the launches, reset before the kernel arm, one of each of
    rows 1-3 a layer and step (and two ``fused_adam``), none in the
    reference arm, the two arms' losses within ``LM_LOSS_TOL``;
9. the kernels line, last: one JSON object listing each kernel with its
   launches on its own path (phase 4 for the paged decode, phase 29 for
   rows 1-5: (a)'s classic loop for the flash kernels and (b)'s for the
   conv_bn kernels) and its
   numbers from phase
   3, 6 or 10 (rows 1-3 also phase 24 (a)'s offset times; rows 1 and 6
   phase 25 (a)'s launches on each TP rank and row 6 its times at H=4;
   rows 1-3 phase 25 (b)'s launches; the fused update phase 30 (b)'s;
   rows 1-3 at (192, 128) phase 31 (a)'s numbers and (c)'s launches).

The last line is ``{"ok": true, "device": {...}}``, after the card's
name and power limit and the script's total seconds.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# max abs error limits against the plain versions (f32: 1e-5 holds
# with a 20x margin on the card; bf16 decode: one bf16 ulp of |o| < 4;
# the bf16 flash forward: one bf16 ulp of the case's largest |o|, as the
# backward's limit: the tensor-core kernel carries P as a bf16 hi + lo
# pair, so its f32 sums differ from the plain version's by about 2^-16
# relative, and the two round them to bf16 once each)
F32_TOL = 1e-5
BF16_TOL = 2e-2
# published H100 SXM peaks (dense): HBM bytes/s; f32 on the CUDA cores
# and bf16 on the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

FLASH_REPLACES = "bigdl_tpu/ops/attention.py:120"
DECODE_REPLACES = "bigdl_tpu/ops/decode_attention.py:205"
CONV1X1_REPLACES = "bigdl_tpu/ops/conv_bn.py:127"
CONVKXK_REPLACES = "bigdl_tpu/ops/conv_bn.py:238"
DQ_REPLACES = "bigdl_tpu/ops/attention.py:390"
DKV_REPLACES = "bigdl_tpu/ops/attention.py:445"
# the kernels phase 2 reads in the SASS, by source: each has a bf16
# kernel on the tensor cores and an f32 one on the CUDA cores, with the
# integer template arguments each is instantiated at (the flash kernels'
# head dim D, 192 standing for (D_qk, D_v) = (192, 128), bf16 only; the
# 1x1 conv's pixels per B copy VEC; None: not templated on an integer)
TENSOR_CORE_KERNELS = {"flash_fwd": ("D", (32, 64, 128, 192),
                                     (32, 64, 128)),
                       "flash_bwd_dq": ("D", (32, 64, 128, 192),
                                        (32, 64, 128)),
                       "flash_bwd_dkv": ("D", (32, 64, 128, 192),
                                         (32, 64, 128)),
                       "conv_bn_kxk": ("", (None,), (None,)),
                       "conv_bn_1x1": ("VEC", (8, 4, 2, 1), (None,))}
# a profiler key of one of csrc/'s kernels (all in anonymous namespaces;
# a template's key starts with its return type, a plain function's not)
PORT_KERNEL = re.compile(r"(?:void )?\(anonymous namespace\)::"
                         r"(flash|paged_decode|conv|stats_reduce)\w*_kernel\b")

# conv_bn limits against the plain version (the same conv in f32 by
# cuDNN, TF32 off): f32 y 1e-4 abs (the kernel and cuDNN sum the C·k²
# products in other orders, up to 4608 of them, and cuDNN may pick a
# Winograd or FFT algorithm); bf16 y within one bf16 ulp of the largest
# |y| (both round an f32 sum that differs in the last bits: they agree
# or straddle one rounding boundary, and near y = 0 the two f32 sums
# differ by more than a bf16 ulp of the tiny value, so the ulp is taken
# at the output's scale, as the flash check does); s1/s2 within 1e-5 of
# the plain version's f32 sums, relative to the largest |sum| over the
# channels (sums of up to 100352 terms in other orders: 3e-7 is the worst
# seen on the H100, and a column of 64 partials dropped from a batch-32
# sum would be some 6e-4). Besides, on x = 0 with power-of-two shifts
# every partial sum is exact, so s1 = -N*Ho*Wo*shift and
# s2 = N*Ho*Wo*shift^2 must hold bit for bit.
CONV_F32_TOL = 1e-4
STATS_REL_TOL = 1e-5
ZERO_X_SHIFTS = (0.5, -0.25, 1.0, -2.0, 0.125, -1.0, 2.0, -0.5)
# ResNet-50 training: batch, image size, classes, timed steps after the
# first, and the limits on |loss, fused - standard| at step 1 and at each
# later step. The builder's zero gamma of each block's last BN would hide
# the block's main branch from the first step's loss and gradient, so
# both arms start from the same gamma drawn from U(0.25, 0.75) (seed 2):
# every fused site then shapes the first loss, and its backward the later
# ones. The arms differ in rounding only (bf16 convs; statistics from the
# f32 accumulator in the fused arm, from the bf16 y in the standard one),
# and both are deterministic run to run on the H100: step 1 differs by
# 2.6e-3 there, a later step by at most 6.0e-2. A fused backward that
# drops the gs2 term exceeds the later limit 2.9x or more at every later
# step, one that drops gs1 and gs2 exceeds it from step 3 on (1.49x
# there, 6.9x at step 6); chip_mutants.py checks both.
TRAIN_BATCH, TRAIN_IMG, TRAIN_CLASSES, TRAIN_STEPS = 32, 224, 1000, 5
LOSS_TOL, LATER_LOSS_TOL = 1e-2, 0.15
# flash backward limits against the plain versions: f32 within 1e-5 of
# the largest |gradient| of the case (the same f32 products summed in
# other orders); bf16 within one bf16 ulp of it (both round an f32 sum
# once, and agree or straddle one rounding boundary: the bf16 kernels
# carry P and dS as bf16 hi + lo pairs, so their f32 sums differ from
# the plain versions' by about 2^-16 relative, far less than an ulp)
BWD_F32_REL = 1e-5
# phase 10 cases: (B, H, Tq, Tk, D, dtype, causal); the first two are
# the training shape, timed, the third the long-context shape, timed;
# the last three take the bf16 kernels through ragged tiles, a
# cross-length grid and D = 32 and 128
FLASH_BWD_CASES = [
    (16, 8, 512, 512, 64, torch.bfloat16, True),
    (16, 8, 512, 512, 64, torch.float32, True),
    (2, 8, 4096, 4096, 64, torch.bfloat16, True),
    (2, 8, 200, 300, 64, torch.float32, False),
    (2, 8, 131, 131, 32, torch.float32, True),
    (2, 8, 200, 200, 128, torch.float32, True),
    (2, 8, 256, 256, 128, torch.bfloat16, False),
    (2, 8, 131, 131, 32, torch.bfloat16, True),
    (2, 8, 200, 300, 64, torch.bfloat16, False),
    (2, 8, 200, 200, 128, torch.bfloat16, True),
]
# transformer training (phase 11): the flagship of bench.py:440-441;
# batch, T and timed steps after the first; the long-context point; the
# limits on the f32 gradients (relative L2 per tensor, kernel arm against
# reference arm) and on |loss, kernel - reference| under bf16
LM = dict(dim=512, n_head=8, n_layer=8)
LM_VOCAB, LM_BATCH, LM_T, LM_STEPS = 8192, 16, 512, 5
LONG_BATCH, LONG_T = 2, 4096
LM_GRAD_REL_TOL, LM_LOSS_TOL = 1e-4, 1e-2
# phase 31: Moonlight-16B-A3B's widths (the benchmark's
# configs/moonlight-16b-a3b.json), the (192, 128) kernels' shape (the
# cell's: B=1, H=16, T=8192), the LM's layers and steps, and the MoE
# layer's limit against its plain f32 version: 3e-2 of the largest |y|
# (the grouped GEMMs round x, h and the products to bf16; the routing
# is the same f32 product of the same bf16 x on both sides, so no
# choice differs, and one expert's rows at a wrong group offset err by
# the size of y itself)
MLA = dict(vocab=20480, dim=2048, dense=11264, heads=16, nope=128, rope=64,
           dv=128, rank=512, hidden=1408, experts=64, top_k=6, shared=2,
           scaling=2.446, held=8, theta=50000.0)
MLA_B, MLA_H, MLA_T = 1, 16, 8192
MLA_LAYERS, MLA_STEPS = 3, 3
MOE_REL_TOL = 3e-2
# the PTB LM (phase 13): bench.py:414-426's model on synthetic_ptb_stream's
# tokens in BPTT windows (15 windows of 64 x 20: one epoch is 15 steps);
# the limits on each card loss against the CPU run's (relative) and on
# the GRU's output and input gradient against the CPU's (relative L2):
# f32 sums of the same products in other orders, TF32 off
PTB_VOCAB, PTB_EMBED, PTB_HIDDEN = 10000, 128, 256
PTB_BATCH, PTB_T, PTB_TOKENS = 64, 20, 20000
PTB_LOSS_REL_TOL, GRU_REL_TOL = 1e-4, 1e-4
# LeNet-5 (phase 14): train_lenet's recipe (bigdl_tpu/models/lenet.py:39)
# at lr 0.1 on synthetic MNIST; the verify skill's Top1 bar for this
# task; the first losses against the CPU run's (relative) and the eval
# Loss against the CPU's (absolute)
LENET_N, LENET_BATCH, LENET_EPOCHS, LENET_LR = 2048, 128, 2, 0.1
LENET_TOP1_MIN, LENET_LOSS_REL_TOL, LENET_EVAL_LOSS_TOL = 0.99, 1e-4, 1e-5
# ResNet-50 from an image folder (phase 15): classes, train and val
# images a class, global batch and epochs of the entry point; the retry's
# synthetic images and epochs; DistriOptimizer's steps against
# LocalOptimizer and its f32 limit (relative, losses and params' L2: at
# world 1 the same f32 products, the gradient scaled by the batch and
# back by a power of two); the steps of each run of the copy A/B
IMG_CLASSES, IMG_TRAIN, IMG_VAL, IMG_BATCH, IMG_EPOCHS = 8, 32, 8, 32, 2
IMG_SIZE = 224
RETRY_N, RETRY_EPOCHS = 64, 3
DISTRI_STEPS, DISTRI_F32_TOL = 3, 1e-5
AB_BATCHES = 8
# BASELINE config 3 (phase 16): the entry point's batch and epochs (over
# phase 15's folder) and the synthetic v2 run's samples; the Caffe round
# trip's forward batch on the card and on the CPU, and its limits
# (relative to the largest |y|: the loaded graph against the exported
# one on the card, the same ops on the same weights; against the CPU,
# f32 sums in other orders, TF32 off); the loaded graphs' training:
# batch, timed steps after the warm-up one, and the CPU comparison's
# batch, steps and relative loss limit.  The CPU limits lie between the
# f32 readings and those of the same runs with TF32 on, the control
# (H100: forward 4.9e-07 and 3.1e-06 against 6.4e-04 and 1.2e-03;
# losses 6.9e-08, one f32 ulp of the loss, against 7.6e-07)
INC_CLI_BATCH, INC_CLI_EPOCHS, INC_V2_N = 32, 1, 64
CAFFE_IMG, CAFFE_FWD_BATCH, CAFFE_CPU_BATCH = 224, 8, 2
CAFFE_CARD_TOL, CAFFE_CPU_TOL = 1e-5, 3e-5
CAFFE_BATCH, CAFFE_STEPS = 32, 5
INC_CPU_BATCH, INC_CPU_STEPS, INC_CPU_TOL = 4, 3, 2.5e-7
# the serving tier (phase 17): classify images a burst (and the
# classifier's batch), and their limit against resnet(x) on the card at
# that batch (relative to the largest |y|: the same cuDNN convs on the
# same shapes, so equal but for the algorithm's order); a drain lands
# after this many tokens of the burst; the int8 GEMM's (M, K, N): the
# decode step's (M = 8 rows) and three ResNet-50 convs at batch 8
# (the 7x7 stem, K = 147; a 3x3 of stage 1; a 3x3 of stage 4, K = 4608)
SERVE_IMAGES, SERVE_CLS_TOL, DRAIN_AFTER_TOKENS = 8, 1e-5, 40
INT8_MM_SHAPES = [("qkvo", (8, 512, 512)), ("fc1", (8, 512, 2048)),
                  ("fc2", (8, 2048, 512)), ("head", (8, 512, 8192)),
                  ("stem", (8 * 112 * 112, 147, 64)),
                  ("3x3 stage 1", (8 * 56 * 56, 576, 64)),
                  ("3x3 stage 4", (8 * 7 * 7, 4608, 512))]
# BASELINE config 5 (phase 17 (f)): bench.py:472-492's frame (4096 rows
# of 64 features, 4 classes), MLP 64-32-4, batch 256, 2 epochs, at SGD
# lr 1.0 (the estimator's default 1e-3 reaches 0.24 training accuracy
# in 2 epochs, 0.5 reaches 0.86: a rate that learns in 2 epochs); the
# training-accuracy gate of tests/test_dlframes.py; LeNet-5 on flat
# synthetic MNIST rows runs at phase 14's recipe
C5_ROWS, C5_FEAT, C5_BATCH, C5_EPOCHS, C5_LR = 4096, 64, 256, 2, 1.0
C5_ACC_MIN = 0.9
# the optim methods (phase 18): (a) steps of each method at the flagship's
# parameter shapes, on the card and on the CPU from the same parameters,
# gradients (those of a quadratic, 0.5·p + a fixed noise, so no entry is
# exactly 0 and LBFGS's sᵀy is positive) and state; limit on what each
# |p_card - p_cpu| exceeds one f32 ulp of p_cpu by, over the largest |Δp|
# of the CPU run (an update an ulp apart can round p - u to neighbouring
# floats: Adam read 5.96e-08, half an ulp of 1.0, against a largest Δp of
# 2.7e-03, on the first H100 run; LBFGS and LarsSGD also sum 34M products
# in other orders); (b) NCF at ml-1m's id ranges with the
# example's widths, batch and Adam rate: the CPU run's first losses and
# their relative limit, the random-ranking levels HitRatio@10 and
# NDCG@10 must beat (the example's log line), and the iteration cap of
# the end trigger (above the epoch's 2241 steps); (c) the flagship in f32
# with Adam under Step(2, 0.5) and the token embedding frozen, 1 + 5
# steps per trainer, and the limit on DistriOptimizer (world 1) against
# LocalOptimizer (relative: losses, and the params' L2); (d) the
# autoencoder's published batch and rate, the first CPU losses gated and
# their limit; (e) the regularized model's sizes, steps and limit
OPT_STEPS, OPT_REL_TOL = 3, 1e-5
NCF_USERS, NCF_ITEMS, NCF_BATCH, NCF_LR = 6040, 3706, 256, 1e-3
NCF_CPU_STEPS, NCF_LOSS_REL_TOL, NCF_MAX_ITER = 20, 1e-4, 3000
NCF_HR_MIN, NCF_NDCG_MIN = 0.10, 0.045
LM_OPT_STEPS, LM_DISTRI_TOL = 5, 1e-5
AE_BATCH, AE_LR, AE_CPU_LOSSES, AE_LOSS_REL_TOL = 128, 0.01, 5, 1e-4
REG_VOCAB, REG_EMBED, REG_HIDDEN, REG_T, REG_BATCH = 1000, 64, 128, 16, 32
REG_STEPS, REG_REL_TOL = 3, 1e-5
# the text CNN (phase 19): (a) train_text_cnn's defaults (the JAX
# example's flags); the limit on each of its first losses against the CPU
# run's, |card - CPU| over the CPU's first loss (f32 sums in other
# orders, TF32 off, cuDNN deterministic: the loss falls from 5.2 to
# 3e-5 by step 19, where 1e-4 of the loss itself is some 3e-9, and a CPU
# run on one thread, another summation order, is 2e-5-9e-5 of the loss
# off the CPU's there); the Top1 the synthetic stand-in's signature
# tokens allow and the largest Top1 gap to the CPU run; (b) the news20 shape: tokenize_corpus's vocab_limit + 1,
# its doc_len, and steps; (c) the log-probabilities' limit, card against
# CPU on the same weights, times the largest magnitude above 1; (d) each
# new class's limit on what |card - CPU| exceeds one f32 ulp by, over the
# largest magnitude of the CPU's value (outputs and gradients), and the
# convs' limit, phase 16's CAFFE_CPU_TOL for the same cause: cuDNN's f32
# weight gradient of ConvLSTMPeephole's hoisted input conv (16 -> 128
# channels over 32 images of 32x32) reads 2.5e-5 off the f64 result where
# the CPU's reads 1.7e-6 and the same conv with cuDNN off 2.8e-7 (H100,
# deterministic or not)
TC_BATCH, TC_EPOCHS, TC_LR, TC_DOC_LEN = 128, 3, 0.05, 32
TC_CPU_STEPS, TC_LOSS_TOL, TC_TOP1_MIN, TC_TOP1_GAP = 20, 1e-6, 0.9, 0.02
TC_NEWS_VOCAB, TC_NEWS_DOC_LEN, TC_NEWS_BATCH, TC_NEWS_STEPS = (20001, 128,
                                                                128, 50)
TC_LOGP_TOL, ITEM14_TOL, ITEM14_CONV_TOL = 1e-5, 1e-5, 3e-5
# the image pipeline and checkpoint layer (phase 21): (a) 2 epochs of
# phase 15's 256 training images (8 steps an epoch) at SGD lr 0.1 with
# momentum 0.9, checkpoints every 4 iterations with 2 kept, "Parameters"
# histograms every 8; (b) and (c) one epoch each, (c) with checkpoints
# every 2 so that the plan's corrupted second write is the newest when
# step 6 raises, and a NaN batch at step 3; (d) predict_image against the
# trained model's forward (f32, the same cuDNN convs on the same
# tensors); (e) the JAX stream tests' MLP (tests/test_stream.py), 12 steps
# of 32 records, checkpoints every 5, a raise at step 8, and a buffer of
# 16 records, under one batch, so the producer waits
P21_EPOCHS, P21_LR, P21_CKPT_EVERY, P21_KEEP, P21_PARAM_EVERY = (2, 0.1, 4,
                                                                  2, 8)
P21_SHORT_STEPS, P21_FAULT_CKPT_EVERY = 8, 2
P21_FAULT_PLAN, P21_NAN_PLAN = "step:6:raise,ckpt:2:corrupt", "step:3:nan_grad"
P21_PRED_TOL = 1e-5
STREAM_STEPS, STREAM_CKPT_EVERY, STREAM_RAISE_AT, STREAM_BUFFER = 12, 5, 8, 16
# DistriOptimizer's wires, buckets, health and resilience (phase 22):
# (a) phase 7's fused ResNet-50 at batch 32 for 8 steps with SGD lr 0.1
# and momentum 0.9, the int8 wire with error feedback, 25 MiB buckets and
# a health report every 4 steps against the f32 wire in one bucket; the
# health report's summed grad_sq within 1e-4 relative of the pre-clip
# gradient's squared norm (f64 in the phase), /healthz stalled past a
# hang timeout of 0.5 s after 1 s idle; (b) the wire's quantizers at
# block 512, 25 runs a timing; (c) the tests' world-2 checkpoint (the
# int8 wire with EF and two buckets) resumed at world 1 on the card and
# on the CPU, epoch 2's 4 steps within 1e-5; (d) LeNet-5 on the card
# through DistriOptimizer, 1024 synthetic MNIST images, batch 128 (8
# steps an epoch), 2 epochs, SIGTERM after step 3's loss
P22_STEPS, P22_LR, P22_HEALTH_EVERY, P22_BUCKET_MB = 8, 0.1, 4, 25.0
P22_BLOCK, P22_HEALTH_REL, P22_HANG_S, P22_RESUME_TOL = 512, 1e-4, 0.5, 1e-5
P22_LENET_N, P22_LENET_BATCH, P22_LENET_EPOCHS, P22_HOLD = 1024, 128, 2, 3
# Wide & Deep, the tree-LSTM, AlexNet and item 16's layers (phase 23):
# (a) bench.py's wide_and_deep key (4096 rows, wide vocab 10000 with 4
# active of 8 slots, deep vocabs 100/50/20, embed 8, hidden 32/16, batch
# 256 of the first rows, f32, SGD lr 0.05), 1 + 20 steps through each
# trainer, the first 20 losses within 1e-4 relative of the CPU's and
# Distri within 1e-5 of Local; then the example's main with
# --distributed -e 2, train-set Top1 within 0.01 of the CPU's; (b) the
# tree-LSTM example at its defaults (batch 128, 8 leaves, embed 16,
# hidden 32, 200 steps, lr 0.3), the losses at steps 50-200 within 1e-4
# relative and the root accuracy equal to the CPU's; (c) AlexNet-OWT at
# 227 px, batch 32, bf16, SGD lr 3e-4 (lr 1e-2 diverges from these
# random weights), 1 + 5 steps, profiled; its first 3 losses at
# batch 4 in f32 (no dropout: its masks are the device's bits) within
# 3e-5 of the CPU's, with TF32 on over that (the control); (e) LeNet-5
# with nan_grad at step 3 and health every 4 in both trainers, card
# against CPU, and phase 22 (a)'s "on" run with the deferred stats and
# without them (the code before the fix) in alternate blocks of steps
P23_WD_N, P23_WD_BATCH, P23_WD_STEPS, P23_WD_LR = 4096, 256, 20, 0.05
P23_WD_VOCAB, P23_WD_DEEP, P23_WD_SLOTS = 10000, (100, 50, 20), 8
P23_WD_REL, P23_WD_DISTRI_REL, P23_WD_TOP1_TOL = 1e-4, 1e-5, 0.01
P23_TREE_ARGS = ["-b", "128", "--n-leaves", "8", "--embed-dim", "16",
                 "--hidden", "32", "--max-steps", "200",
                 "--learning-rate", "0.3"]
P23_TREE_REL = 1e-4
P23_ALEX_BATCH, P23_ALEX_IMG, P23_ALEX_STEPS, P23_ALEX_LR = 32, 227, 5, 3e-4
P23_ALEX_CPU_BATCH, P23_ALEX_CPU_STEPS, P23_ALEX_CPU_TOL = 4, 3, 3e-5
P23_HEALTH_EVERY, P23_NAN_STEP, P23_LENET_STEPS = 4, 3, 6
# the "on" step's A/B: alternate blocks of 4 steps of one 96-step run,
# each step timed from its dispatch to the card done; the step with the
# fix may read over the code before it by 3% or by twice the standard
# error of the difference of the means, whichever is larger (steps of
# one run spread by some 12%: the host)
P23_AB_STEPS, P23_ON_SLOWER = 96, 0.03
# phase 24: (a) rows 1-3 at a query offset (B=2, H=8, D=64, causal),
# each (Tq, Tk) at offsets 0, 37, 64 and Tk - Tq, timed at (512, 1024)
# at offsets 0 and 512; (b) the tuner's measured decisions: attention at
# phase 3's and 10's bf16 shapes, conv_bn at three fused ResNet-50 sites
# of phase 6 (batch 32, bf16: stage 1's 1x1 and 3x3, stage 2's strided
# 3x3), the paged decode at phase 4's shape and used-page bucket (B=8,
# H=8, Dh=64, page 16, 32 pages, f32) and int8_mm at phase 17's shapes;
# (c) the long-context LM through train_long_lm at the flagship's width
# (bench.py:429-441) at phase 11's long-context point, three ways, then
# the tuner on and off in alternate blocks of steps of one run; (d) the
# ring module at world 1 against the plain one
P24_B, P24_H, P24_D = 2, 8, 64
P24_SHAPES = [(512, 512), (512, 1024), (200, 333)]
P24_TIMED, P24_TIMED_OFFSETS = (512, 1024), (0, 512)
P24_CONV_SITES = [((32, 64, 56, 56), (64, 64, 1, 1), 1, 0),
                  ((32, 64, 56, 56), (64, 64, 3, 3), 1, 1),
                  ((32, 128, 56, 56), (128, 128, 3, 3), 2, 1)]
P24_DECODE = dict(b=8, h=8, d=64, page_size=16, maxp=32)
# (b) under torch.no_grad, as LMEngine's prefill and an eval pass reach
# their sites: one prompt of phase 4's lengths (B=1, T=400), and stage
# 1's 3x3 conv at an eval batch of 8
P24_NO_GRAD_PREFILL_T, P24_NO_GRAD_CONV_N = 400, 8
P24_LM = ["--seq", str(LONG_T), "--batch", str(LONG_BATCH), "--dim", "512",
          "--heads", "8", "--layers", "8", "--vocab", "8192",
          "--dtype", "bfloat16"]
# steps of each way (the first not timed); the A/B's blocks and steps a
# block (a block's first step not counted)
P24_STEPS, P24_AB_BLOCKS, P24_AB_BLOCK = 4, 8, 3
# phase 11's kernel-arm SGD step (bf16), for phase 18 (c) to print beside
# Adam's
_LM_SGD_MS = {}
# the device of the conv_bn, flash backward and training phases
DEV = "cuda"
# clock cycles of the busy wait before a device-only timing (some 2 ms at
# the H100's 1.98 GHz boost clock): longer than the host takes to queue
# any call timed that way
SLEEP_CYCLES = 4_000_000


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def _model_launches() -> dict:
    """``_cuda.launches`` without the optimizer update's kernel: a phase
    that trains a model with no kernel site checks that these stay put,
    while its Adam goes through ``fused_adam`` (phase 30)."""
    from bigdl_tpu_torch.ops import _cuda

    return {k: n for k, n in _cuda.launches.items() if k != "fused_adam"}


def time_ms(fn, reps: int = 25, warmup: int = 3,
            device_only: bool = False) -> float:
    """Median time of ``fn`` over ``reps`` runs between two CUDA events.

    By default the card may wait between the call's kernels for the host
    to launch them, so a call of several small kernels reads at least
    the host's time to issue them.  With ``device_only`` the card is
    first held busy (``torch.cuda._sleep``, some 2 ms) while the host
    queues the call, so the events see the call's kernels back to back:
    its device time."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if device_only:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        events.append((start, end))
        if device_only:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in events]))


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(name: str, err: float, tol: float) -> None:
    if not np.isfinite(err) or err > tol:
        raise AssertionError(f"{name}: max abs err {err:.3e} > {tol:g}")


def phase_device() -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(f"phase 1 device: {name}, count {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, cuda {torch.version.cuda}, "
        "allow_tf32 False")
    print(smi, flush=True)
    return smi


def _kernel_key(mangled: str):
    """(kernel, its integer template argument or None) of a mangled
    kernel name of ``TENSOR_CORE_KERNELS``, or None."""
    m = re.search(r"((?:flash_(?:fwd|bwd_dq|bwd_dkv)|conv_bn_kxk|conv_bn_1x1)"
                  r"_(?:bf16|f32)_kernel)(?:ILi(\d+)E)?", mangled)
    if not m:
        return None
    return m.group(1), int(m.group(2)) if m.group(2) else None


def _ptxas_usage(log: str) -> dict:
    """{(kernel, D): [registers, spill bytes]} from ``-Xptxas=-v``."""
    usage, key = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            key = _kernel_key(m.group(1))
            if key:
                usage[key] = [None, 0]
            continue
        if key is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[key][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[key][0] = int(m.group(1))
    return usage


def _hmma_counts(lib_path: str) -> dict:
    """{(kernel, D): bf16 HMMA instructions} in a library's SASS."""
    from bigdl_tpu_torch.config import nvcc_path

    tool = os.path.join(os.path.dirname(nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            key = _kernel_key(line)
            if key:
                counts[key] = 0
        elif key and "HMMA" in line and "BF16" in line:
            counts[key] += 1
    return counts


def phase_build() -> None:
    from bigdl_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    compile_s = _cuda.build()
    say(f"phase 2 build: nvcc {compile_s:.1f} s for "
        f"{', '.join(_cuda.SOURCES.values())} (in parallel), "
        f"{time.perf_counter() - t0:.1f} s with loading")
    spilled = []
    for name, (arg, dims, f32_dims) in TENSOR_CORE_KERNELS.items():
        hmma = _hmma_counts(_cuda._lib_path(name))
        usage = _ptxas_usage(_cuda.build_logs.get(name, ""))
        keys = ([(f"{name}_bf16_kernel", d) for d in dims]
                + [(f"{name}_f32_kernel", d) for d in f32_dims])
        for key in keys:
            n = hmma.get(key)
            if n is None or (n > 0) != ("bf16" in key[0]):
                raise AssertionError(f"{key}: {n} bf16 HMMA instructions "
                                     "in its SASS")
        for d in dims:
            regs, spill = usage.get((f"{name}_bf16_kernel", d), (None, None))
            if not usage:                       # a build of an earlier run
                regs = spill = "not reported"
            elif regs is None or spill:
                spilled.append(f"{name} bf16 {arg}={d}: ptxas reports "
                               f"{regs} registers, {spill} bytes of spills")
            at = "" if d is None else f" {arg}={d}"
            say(f"phase 2 {name} bf16{at}: "
                f"{hmma[(f'{name}_bf16_kernel', d)]} bf16 HMMA in its SASS "
                f"(f32 kernel: 0); ptxas: {regs} registers, {spill} bytes "
                "spilled")
    if spilled:     # every kernel's report printed first
        raise AssertionError("; ".join(spilled))


def _flash_case(b, h, t, d, dtype, causal, gen):
    """One forward case, run twice (bit-equal) against the plain
    version: (max abs err, its limit, lse max abs err)."""
    from bigdl_tpu_torch.ops.attention import (flash_attention,
                                               flash_attention_plain)

    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    out2, lse2 = flash_attention(q, k, v, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    name = f"flash_fwd B={b} H={h} T={t} D={d} {str(dtype)[6:]} causal={causal}"
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)):
        raise AssertionError(f"{name}: two runs on one input differ")
    flat = (b * h, t, d)
    ref, ref_lse = flash_attention_plain(
        q.reshape(flat), k.reshape(flat), v.reshape(flat), causal=causal,
        scale=d ** -0.5)
    err = (out.reshape(flat).float() - ref.float()).abs().max().item()
    tol = (F32_TOL if dtype == torch.float32
           else _bf16_ulp(ref.float().abs().max().item()))
    lse_err = (lse - ref_lse).abs().max().item()
    return name, err, tol, lse_err


def _flash_fwd_times(b, h, t, d, dt, gen, plain: bool = True) -> dict:
    """The forward at one causal shape: the kernel (through
    ``flash_attention``), the plain version, the forward of
    scaled_dot_product_attention, the bound, TFLOP/s and share of the
    bound (4·D FLOPs per causal pair)."""
    from bigdl_tpu_torch.ops.attention import (flash_attention,
                                               flash_attention_plain)

    q, k, v = (torch.randn((b, h, t, d), generator=gen, device="cuda")
               .to(dt) for _ in range(3))
    flat = [x.reshape(b * h, t, d) for x in (q, k, v)]
    def kernel():
        flash_attention(q, k, v, causal=True)

    def sdpa():
        torch.nn.functional.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True)

    row = dict(ms=time_ms(kernel), device_ms=time_ms(kernel,
                                                     device_only=True))
    row["plain_ms"] = (time_ms(lambda: flash_attention_plain(
        *flat, causal=True, scale=d ** -0.5)) if plain else None)
    row["library_ms"] = time_ms(sdpa)
    row["library_device_ms"] = time_ms(sdpa, device_only=True)
    nbytes = 4 * b * h * t * d * q.element_size()  # q, k, v read; o written
    flops = 4 * b * h * d * t * (t + 1) / 2        # causal pairs only
    row["bound_ms"], row["bound_by"] = bound(nbytes, flops, dt)
    row["tflops"] = flops / (row["device_ms"] * 1e-3) / 1e12
    row["of_bound"] = row["bound_ms"] / row["device_ms"]
    plain_s = (f"plain {row['plain_ms']:.4f} ms, " if plain
               else "plain not timed, ")
    say(f"phase 3 flash_fwd time B={b} H={h} T={t} D={d} {str(dt)[6:]}: "
        f"kernel {row['ms']:.4f} ms a call, {row['device_ms']:.4f} ms on the "
        f"device ({row['tflops']:.1f} TFLOP/s, {row['of_bound']:.3f} of the "
        f"bound), {plain_s}sdpa {row['library_ms']:.4f} ms a call, "
        f"{row['library_device_ms']:.4f} ms on the device, bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    return row


def phase_flash(gen) -> dict:
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # the prefill shapes (B=1, H=8, D=64, causal), ragged and other head
    # widths the kernel takes, and in bf16 the transformer's training
    # shape and the long-context shape: (B, H, T, D, dtype, causal)
    cases = [(1, 8, t, 64, dt, True) for dt in (torch.float32, torch.bfloat16)
             for t in (128, 256, 512)]
    cases += [(1, 8, 200, 64, torch.float32, False),
              (1, 8, 131, 32, torch.float32, True),
              (1, 8, 96, 128, torch.bfloat16, False),
              (1, 8, 131, 32, torch.bfloat16, True),
              (LM_BATCH, 8, LM_T, 64, torch.bfloat16, True),
              (LONG_BATCH, 8, LONG_T, 64, torch.bfloat16, True)]
    for case in cases:
        name, err, tol, lse_err = _flash_case(*case, gen)
        check(name, err, tol)
        check(f"{name} lse", lse_err, F32_TOL)
        worst[case[4]] = max(worst[case[4]], err)
        say(f"phase 3 {name}: max abs err {err:.3e} (limit {tol:.3e}), lse "
            f"{lse_err:.3e}; bit-equal run to run")
    rows = {(dt, t): _flash_fwd_times(1, 8, t, 64, dt, gen)
            for dt in (torch.float32, torch.bfloat16) for t in (128, 256, 512)}
    train = _flash_fwd_times(LM_BATCH, 8, LM_T, 64, torch.bfloat16, gen)
    long = _flash_fwd_times(LONG_BATCH, 8, LONG_T, 64, torch.bfloat16, gen,
                            plain=False)
    main = {k: v for k, v in rows[(torch.float32, 512)].items()
            if k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
    return dict(name="flash_fwd", route="cuda",
                source="bigdl_tpu_torch/csrc/flash_fwd.cu",
                replaces=FLASH_REPLACES,
                max_abs_err=worst[torch.float32],
                max_abs_err_bf16=worst[torch.bfloat16],
                shape="B=1 H=8 T=512 D=64 f32 causal", **main,
                train_shape=f"B={LM_BATCH} H=8 T={LM_T} D=64 bf16 causal",
                **{f"train_{k}": train[k] for k in
                   ("ms", "device_ms", "plain_ms", "library_ms",
                    "library_device_ms", "bound_ms", "tflops")},
                long_shape=f"B={LONG_BATCH} H=8 T={LONG_T} D=64 bf16 causal",
                **{f"long_{k}": long[k] for k in
                   ("ms", "device_ms", "library_ms", "library_device_ms",
                    "bound_ms", "tflops")})


DECODE_LENGTHS = [511, 17, 255, 16, 15, 300, 1, 128]


def _decode_state(gen, q_dtype, kv_dtype, b=8, h=8, d=64, p=16, maxp=32,
                  lengths=None):
    lengths = (DECODE_LENGTHS if lengths is None else lengths)[:b]
    pool = 1 + b * maxp
    kp = torch.randn((pool, h, p, d), generator=gen, device=DEV)
    vp = torch.randn((pool, h, p, d), generator=gen, device=DEV)
    kp[0] = 1e30                                 # the trash page
    vp[0] = 1e30
    rs = np.random.RandomState(0)
    free = list(rs.permutation(np.arange(1, pool)))
    tables = np.zeros((b, maxp), np.int32)
    for i, ln in enumerate(lengths):
        for j in range(min(ln // p + 1, maxp)):
            tables[i, j] = free.pop()
    q = torch.randn((b, h, d), generator=gen, device=DEV).to(q_dtype)
    return (q, kp.to(kv_dtype), vp.to(kv_dtype),
            torch.from_numpy(tables).to(DEV),
            torch.tensor(lengths, dtype=torch.int32, device=DEV))


def phase_decode(gen) -> dict:
    from bigdl_tpu_torch.ops.decode_attention import (decode_splits,
                                                      paged_decode,
                                                      paged_decode_plain)

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    f32, bf16 = torch.float32, torch.bfloat16
    # (name, q dtype, cache dtype, state arguments): the serving state in
    # each dtype pair; one slot at 511 with the others at length 0 (its
    # KV over every split, theirs in split 0 and the rest empty); a
    # bucket of width 1 (one split: no merge); a bf16 cache at Dh = 128
    cases = [("", qd, kvd, {}) for qd, kvd in ((f32, f32), (f32, bf16),
                                               (bf16, bf16))]
    cases += [("one slot at 511", f32, f32, dict(lengths=[511] + [0] * 7)),
              ("bucket 1", f32, f32,
               dict(maxp=1, lengths=[15, 0, 7, 3, 15, 1, 9, 12])),
              ("Dh=128", bf16, bf16, dict(d=128))]
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    for name, qd, kvd, kw in cases:
        q, kp, vp, tables, lengths = _decode_state(gen, qd, kvd, **kw)
        out = paged_decode(q, kp, vp, tables, lengths, page_size=16)
        again = paged_decode(q, kp, vp, tables, lengths, page_size=16)
        torch.cuda.synchronize()
        b, h, d = q.shape
        label = (f"paged_decode {name + ' ' if name else ''}q "
                 f"{str(qd)[6:]} cache {str(kvd)[6:]} Dh={d} bucket "
                 f"{tables.shape[1]} ({decode_splits(b, h, tables.shape[1], sms)}"
                 " splits)")
        if not torch.equal(out, again):
            raise AssertionError(f"{label}: two runs on one input differ")
        ref = paged_decode_plain(q, kp, vp, tables, lengths, page_size=16,
                                 scale=d ** -0.5)
        err = (out.float() - ref.float()).abs().max().item()
        tol = F32_TOL if qd == torch.float32 else BF16_TOL
        check(label, err, tol)
        worst[qd] = max(worst[qd], err)
        say(f"phase 3 {label}: max abs err {err:.3e}; bit-equal run to run")
    q, kp, vp, tables, lengths = _decode_state(gen, torch.float32,
                                               torch.float32)

    def kernel():
        paged_decode(q, kp, vp, tables, lengths, page_size=16)

    ms = time_ms(kernel)
    device_ms = time_ms(kernel, device_only=True)
    plain = time_ms(lambda: paged_decode_plain(q, kp, vp, tables, lengths,
                                               page_size=16, scale=0.125))
    b, h, d = q.shape
    splits = decode_splits(b, h, tables.shape[1], sms)
    positions = int((lengths + 1).sum())
    pages = int((lengths // 16 + 1).sum())
    nbytes = (2 * b * h * d * 4                  # q read, out written
              + 2 * positions * h * d * 4        # live K and V rows
              + pages * 4 + b * 4)               # live table entries, lengths
    flops = 4 * h * d * positions
    b_ms, b_by = bound(nbytes, flops, torch.float32)
    say(f"phase 3 paged_decode time B=8 H=8 Dh=64 P=16 f32, {splits} "
        f"splits: kernel {ms:.4f} ms a call, {device_ms:.4f} ms on the "
        f"device, plain {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(name="paged_decode", route="cuda",
                source="bigdl_tpu_torch/csrc/paged_decode.cu",
                replaces=DECODE_REPLACES, max_abs_err=worst[torch.float32],
                max_abs_err_bf16=worst[torch.bfloat16], ms=ms,
                device_ms=device_ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                shape=f"B=8 H=8 Dh=64 P=16 f32, lengths up to 511, "
                      f"{splits} splits")


# phase 4's served tokens (tp=1), for phase 25 (a)
_P4_TOKENS: list = []
# phase 4's prompts (100-400 tokens, seed 0) and new tokens a request
SERVE_PROMPT_LENS = [100, 400, 127, 260, 200, 350, 256, 130, 300, 120, 390,
                     250]
SERVE_NEW_TOKENS = 32
SERVE_MAX_BATCH = 8


def _serving_prompts() -> list:
    rs = np.random.RandomState(0)
    return [rs.randint(0, 8192, n) for n in SERVE_PROMPT_LENS]


def _flagship(seed: int):
    """The flagship TransformerLM of bench.py:429-441 on the card, random
    f32 weights from ``seed``, the flash prefill kernel."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.transformer import build_transformer_lm

    RandomGenerator.RNG.set_seed(seed)
    return build_transformer_lm(8192, dim=512, n_head=8, n_layer=8,
                                max_len=512, attn_impl="kernel",
                                device=DEV)


def _lm_engine(model, decode_attn="kernel", **kw):
    from bigdl_tpu_torch.serving.engine import LMEngine

    return LMEngine(model, max_batch=SERVE_MAX_BATCH, page_size=16,
                    decode_attn=decode_attn, device=DEV, **kw)


def _top_logit_gap(model, prompts, token_lists) -> float:
    """The worst (top logit - the served token's logit) over every
    served token, from one full forward of ``model`` over each prompt
    and its tokens."""
    worst = 0.0
    with torch.no_grad():
        for p, toks in zip(prompts, token_lists):
            seq = torch.tensor(list(p) + list(toks), device=DEV)[None]
            logits = model(seq[:, :-1])[0].float()
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite logits in the forward")
            rows = logits[len(p) - 1:]
            got = rows.gather(1, torch.tensor(list(toks),
                                              device=DEV)[:, None])
            worst = max(worst, (rows.max(dim=1).values - got[:, 0]).max()
                        .item())
    return worst


def phase_main_path() -> tuple:
    from bigdl_tpu_torch.ops import _cuda

    model = _flagship(0)
    eng = _lm_engine(model)
    prompts = _serving_prompts()
    buckets = sorted({eng._bucket(n) for n in SERVE_PROMPT_LENS})
    new_tokens = SERVE_NEW_TOKENS

    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new_tokens) for p in prompts]
    eng.run_until_idle(600)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    st = eng.stats()
    eng.close()
    _P4_TOKENS[:] = [r.tokens for r in reqs]
    say(f"phase 4 served {st['requests']} requests, {st['tokens']} tokens "
        f"in {wall:.3f} s; prefill buckets {buckets}; steps {st['steps']}; "
        f"preemptions {st['preemptions']}; launches {launches}")
    say(f"phase 4 ttft p50 {st['ttft_p50_s'] * 1e3:.2f} ms, "
        f"tokens/s {st['tokens_per_s']:.1f}, decode step "
        f"{st['decode_ms_mean']:.3f} ms mean")
    if any(r.error or len(r.tokens) != new_tokens for r in reqs):
        raise AssertionError("a request failed or came back short")

    worst_gap = _top_logit_gap(model, prompts, [r.tokens for r in reqs])
    exact, prefix = 0, []
    with torch.no_grad():
        for p, r in zip(prompts, reqs):
            ref = model.generate(p[None], new_tokens)[0, len(p):].tolist()
            exact += ref == r.tokens
            same = next((i for i, (a, b) in enumerate(zip(ref, r.tokens))
                         if a != b), new_tokens)
            prefix.append(same)
    say(f"phase 4 check: worst (top logit - served token's logit) over all "
        f"tokens {worst_gap:.3e} (limit 1e-3); exact match with generate() "
        f"{exact}/{len(reqs)} requests, mean matching prefix "
        f"{np.mean(prefix):.1f}/{new_tokens} tokens")
    if worst_gap > 1e-3:
        raise AssertionError(f"served token off the top logit by {worst_gap}")
    return model, launches, st


def phase_profile(model) -> None:
    """Device busy share and top kernels over ten decode steps of a
    full batch (8 slots, 256-token prompts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = _lm_engine(model)
    rs = np.random.RandomState(1)
    for _ in range(8):
        eng.submit(rs.randint(0, 8192, 256), 40)
    for _ in range(5):                   # admit all eight, warm the step
        eng.pump()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(10):
            eng.pump()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    eng.close()
    # device-side events only (kernels, copies): the host ops that
    # launched them carry the same time again
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    if not rows:
        say("phase 5 profile: the profiler shows no device time "
            f"(device busy share not measured); wall {wall_ms / 10:.3f} ms "
            "per step")
        return
    say(f"phase 5 profile: {wall_ms / 10:.3f} ms per decode step (wall), "
        f"device busy {busy_ms / 10:.3f} ms per step, busy share "
        f"{busy_ms / wall_ms:.3f}")
    # the eight largest, then the port's own kernels (csrc/) below them
    ours = [r for r in rows[8:] if PORT_KERNEL.match(r[2])]
    for ms, n, key in rows[:8] + ours:
        say(f"phase 5 profile:   {ms / 10:8.4f} ms/step  x{n // 10:<4d} "
            f"{key[:90]}")


def _resnet50_sites(model, batch: int, img: int) -> list:
    """(x shape, w shape, stride, pad) of every fused site of ``model``
    in call order, read by forward pre-hooks over one eval forward."""
    from bigdl_tpu_torch.nn.fused import SpatialConvolutionBatchNorm

    sites, hooks = [], []
    for m in model.modules():
        if isinstance(m, SpatialConvolutionBatchNorm):
            k = m.kernel
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp, k=k: sites.append((
                    tuple(inp[0].shape),
                    (mod.n_output_plane, mod.n_input_plane, k, k),
                    mod.stride, mod.pad))))
    model.eval()
    with torch.no_grad():
        model(torch.zeros((batch, 3, img, img), device=DEV))
    for h in hooks:
        h.remove()
    return sites


def _bf16_ulp(mag: float) -> float:
    """One bf16 ulp at magnitude ``mag`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(max(mag, 2.0 ** -126))) - 7)


def _conv_case(x_shape, w_shape, stride, pad, dtype, gen):
    """Check one shape: (max abs err, share of y elements that differ,
    s1 rel, s2 rel, inputs).  Runs the kernel twice and demands
    bit-equal statistics."""
    from bigdl_tpu_torch.ops.conv_bn import (conv_bn_stats,
                                             conv_bn_stats_plain)

    o, c, k, _ = w_shape
    x = torch.randn(x_shape, generator=gen, device=DEV).to(dtype)
    w = (torch.randn(w_shape, generator=gen, device=DEV)
         * (2.0 / (c * k * k)) ** 0.5).to(dtype)
    shift = torch.randn(o, generator=gen, device=DEV) * 0.1
    y, s1, s2 = conv_bn_stats(x, w, shift, stride=stride, pad=pad)
    _, s1b, s2b = conv_bn_stats(x, w, shift, stride=stride, pad=pad)
    torch.cuda.synchronize()
    if not (torch.equal(s1, s1b) and torch.equal(s2, s2b)):
        raise AssertionError(f"conv_bn {x_shape} {w_shape}: statistics "
                             "differ between two runs on one input")
    ry, r1, r2 = conv_bn_stats_plain(x, w, shift, stride, pad)
    diff = (y.float() - ry.float()).abs()
    err = diff.max().item()
    differ = (diff > 0).float().mean().item()
    rel = [((a - b).abs().max() / b.abs().max()).item()
           for a, b in ((s1, r1), (s2, r2))]
    name = f"conv_bn {x_shape} w {w_shape} s{stride} {str(dtype)[6:]}"
    check(name, err, CONV_F32_TOL if dtype == torch.float32
          else _bf16_ulp(ry.float().abs().max().item()))
    for which, r in zip(("s1", "s2"), rel):
        if not r <= STATS_REL_TOL:
            raise AssertionError(f"{name}: {which} rel err {r:.3e} > "
                                 f"{STATS_REL_TOL}")
    # x = 0: y is 0 and every valid output adds exactly -shift, shift^2
    z_shift = torch.tensor(ZERO_X_SHIFTS, device=DEV).repeat(
        -(-o // len(ZERO_X_SHIFTS)))[:o]
    zy, z1, z2 = conv_bn_stats(torch.zeros_like(x), w, z_shift,
                               stride=stride, pad=pad)
    cnt = float(zy.shape[0] * zy.shape[2] * zy.shape[3])
    if not (torch.equal(z1, -cnt * z_shift)
            and torch.equal(z2, cnt * z_shift * z_shift)
            and not zy.float().abs().max().item()):
        raise AssertionError(f"{name}: statistics of x = 0 are not exactly "
                             f"N*Ho*Wo = {cnt:.0f} shifts")
    return err, differ, rel[0], rel[1], (x, w, shift)


def _taps(size: int, k: int, stride: int, pad: int, out: int) -> int:
    """How many of ``size`` input rows (or columns) the ``out`` outputs
    of a k-tap, strided, padded window read: a strided 1x1 conv reads
    only every stride-th."""
    return len({i * stride - pad + d for i in range(out) for d in range(k)}
               & set(range(size)))


def _kxk_k1_ms(x, w, shift, stride) -> float:
    """The yardstick of a bf16 1x1 site: the bf16 ``conv_bn_kxk`` kernel
    at k = 1 (its NHWC layout pass included) through
    ``_cuda.launch_conv_bn_kxk`` directly, on the device alone."""
    from bigdl_tpu_torch.ops import _cuda

    n, c, h, wd = x.shape
    o = w.shape[0]
    ho, wo = (h - 1) // stride + 1, (wd - 1) // stride + 1
    cp = -(-c // 8) * 8
    y = x.new_empty((n, o, ho, wo))
    part = torch.empty((2, o, _cuda.conv_mma_tiles(n * ho * wo)),
                       dtype=torch.float32, device=x.device)
    s1, s2 = (torch.empty(o, dtype=torch.float32, device=x.device)
              for _ in range(2))
    scratch = (x.new_empty((n, h, wd, cp)), w.new_empty((o, 1, 1, cp)))
    return time_ms(lambda: _cuda.launch_conv_bn_kxk(
        x, w, shift, y, part, s1, s2, stride=stride, pad=0,
        scratch=scratch), device_only=True)


def _conv_times(x, w, shift, stride, pad) -> dict:
    from bigdl_tpu_torch.ops.conv_bn import (conv_bn_stats,
                                             conv_bn_stats_plain)

    n, c, h, wd = x.shape
    o, _, k, _ = w.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (wd + 2 * pad - k) // stride + 1
    def kernel():
        conv_bn_stats(x, w, shift, stride=stride, pad=pad)

    def conv2d():
        torch.nn.functional.conv2d(x, w, stride=stride, padding=pad)

    ms = time_ms(kernel)
    plain = time_ms(lambda: conv_bn_stats_plain(x, w, shift, stride, pad))
    lib = time_ms(conv2d)
    itemsize = x.element_size()
    x_read = n * c * _taps(h, k, stride, pad, ho) * _taps(wd, k, stride, pad,
                                                           wo)
    nbytes = (x_read + w.numel() + n * o * ho * wo) * itemsize \
        + 3 * o * 4                                  # shift read, s1/s2
    flops = 2 * n * o * c * k * k * ho * wo
    b_ms, b_by = bound(nbytes, flops, x.dtype)
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, flops=flops,
                device_ms=time_ms(kernel, device_only=True),
                library_device_ms=time_ms(conv2d, device_only=True))


def phase_conv_bn(gen) -> list:
    """conv_bn kernels against their plain version at every distinct
    fused ResNet-50 site (bf16), three f32 cases and the kxk probe
    shape; times per shape and summed over one training step."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.resnet import build_resnet_imagenet
    from bigdl_tpu_torch.nn.fused import fuse_conv_bn

    RandomGenerator.RNG.set_seed(0)
    model = fuse_conv_bn(build_resnet_imagenet(50, TRAIN_CLASSES,
                                               device=DEV))
    sites = _resnet50_sites(model, TRAIN_BATCH, TRAIN_IMG)
    del model
    torch.cuda.empty_cache()
    distinct = list(dict.fromkeys(sites))
    n1 = sum(1 for s in distinct if s[1][2] == 1)
    say(f"phase 6 conv_bn: {len(sites)} fused sites, {len(distinct)} "
        f"distinct shapes ({n1} 1x1, {len(distinct) - n1} kxk)")
    if len(sites) != 52 or n1 != 15 or len(distinct) != 22:
        raise AssertionError("ResNet-50 should have 52 fused sites of 15 "
                             "1x1 and 7 kxk shapes")
    # worst errors by (1x1?, dtype)
    worst = {(k1, dt): 0.0 for k1 in (True, False)
             for dt in (torch.float32, torch.bfloat16)}
    worst_rel = 0.0
    rows = {}
    cases = [(s, torch.bfloat16) for s in distinct]
    # f32: a 1x1, a strided 1x1 and a strided 3x3 site at full batch
    cases += [(distinct[2], torch.float32), (distinct[7], torch.float32),
              (distinct[5], torch.float32)]
    # bf16 kxk with C not a multiple of 8 (zero-padded in the layout pass):
    # a strided one with O off the channel tile, and a C = 3 one
    cases += [(((8, 20, 28, 28), (40, 20, 3, 3), 2, 1), torch.bfloat16),
              (((4, 3, 32, 32), (16, 3, 3, 3), 1, 1), torch.bfloat16)]
    # bf16 1x1 off ResNet-50's shapes: odd HW at C = 64 (the gather), HW
    # even but not a multiple of 4 (4-byte copies), and C = 20, which goes
    # to the kxk kernel at k = 1 (strided)
    cases += [(((3, 64, 7, 7), (64, 64, 1, 1), 1, 0), torch.bfloat16),
              (((2, 32, 5, 6), (48, 32, 1, 1), 1, 0), torch.bfloat16),
              (((4, 20, 7, 7), (16, 20, 1, 1), 2, 0), torch.bfloat16)]
    probe = ((8, 64, 16, 16), (64, 64, 3, 3), 1, 1)   # scripts/kxk_probe.py
    cases.append((probe, torch.bfloat16))
    for (xs, ws, stride, pad), dt in cases:
        err, differ, r1, r2, args = _conv_case(xs, ws, stride, pad, dt,
                                               gen)
        key = (ws[2] == 1, dt)
        worst[key] = max(worst[key], err)
        worst_rel = max(worst_rel, r1, r2)
        t = _conv_times(*args, stride, pad)
        yard = ""
        if ws[2] == 1 and dt == torch.bfloat16:
            t["kxk_k1_device_ms"] = _kxk_k1_ms(*args, stride)
            yard = f", kxk at k=1 {t['kxk_k1_device_ms']:.4f} ms on the device"
        rows[(xs, ws, stride, pad, dt)] = t
        tag = "probe " if (xs, ws, stride, pad) == probe else ""
        say(f"phase 6 conv_bn {tag}x {xs} w {ws} s{stride} "
            f"{str(dt)[6:]}: max abs err {err:.3e} ({differ:.2e} of y "
            f"differs), s1/s2 rel {r1:.2e}/{r2:.2e}; kernel {t['ms']:.4f} ms "
            f"a call, {t['device_ms']:.4f} ms on the device{yard}, plain "
            f"{t['plain_ms']:.4f} ms, conv2d alone {t['library_ms']:.4f} ms "
            f"a call, {t['library_device_ms']:.4f} ms on the device, bound "
            f"{t['bound_ms']:.5f} ms ({t['bound_by']})")
    say(f"phase 6 conv_bn worst: bf16 max abs "
        f"{max(worst[(k1, torch.bfloat16)] for k1 in (True, False)):.3e} "
        f"(limit one bf16 ulp of max |y|), f32 max abs "
        f"{max(worst[(k1, torch.float32)] for k1 in (True, False)):.3e} "
        f"(limit {CONV_F32_TOL:g}), s1/s2 rel {worst_rel:.2e} (limit "
        f"{STATS_REL_TOL:g}); statistics bit-equal run to run")
    out = []
    for name, k1, replaces in (("conv_bn_1x1", True, CONV1X1_REPLACES),
                               ("conv_bn_kxk", False, CONVKXK_REPLACES)):
        step = [rows[s + (torch.bfloat16,)] for s in sites
                if (s[1][2] == 1) == k1]
        keys = ["ms", "device_ms", "plain_ms", "library_ms",
                "library_device_ms", "bound_ms"]
        keys += ["kxk_k1_device_ms"] if k1 else []
        tot = {key: sum(r[key] for r in step) for key in keys}
        yard = (f", the kxk kernel at k = 1 {tot['kxk_k1_device_ms']:.4f} ms "
                "on the device" if k1 else "")
        by_ops = sum(r["bound_ms"] for r in step
                     if r["bound_by"] == "operations")
        tflops = (sum(r["flops"] for r in step)
                  / (tot["device_ms"] * 1e-3) / 1e12)
        say(f"phase 6 {name} per training step ({len(step)} launches, "
            f"batch {TRAIN_BATCH}, bf16): kernel {tot['ms']:.4f} ms in "
            f"calls, {tot['device_ms']:.4f} ms on the device ({tflops:.1f} "
            f"TFLOP/s, {tot['bound_ms'] / tot['device_ms']:.3f} of the "
            f"bound){yard}, plain {tot['plain_ms']:.4f} ms, conv2d alone "
            f"{tot['library_ms']:.4f} ms in calls, "
            f"{tot['library_device_ms']:.4f} ms on the device, bound "
            f"{tot['bound_ms']:.5f} ms ({by_ops / tot['bound_ms']:.2f} of it "
            "by operations)")
        out.append(dict(
            name=name, route="cuda",
            source=f"bigdl_tpu_torch/csrc/{name}.cu", replaces=replaces,
            max_abs_err=worst[(k1, torch.float32)],
            max_abs_err_bf16=worst[(k1, torch.bfloat16)],
            bound_by="operations" if by_ops >= tot["bound_ms"] / 2
            else "bytes",
            library="torch.nn.functional.conv2d alone (no statistics)",
            shape=f"sum over the {len(step)} sites of one fused ResNet-50 "
                  f"training step, batch {TRAIN_BATCH}, "
                  f"{TRAIN_IMG}x{TRAIN_IMG}, bf16", tflops=tflops, **tot))
    return out


class _Losses:
    """The train-summary hook: each step's loss."""

    def __init__(self):
        self.loss = {}

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.loss[step] = value


def _training_resnet50(fused: bool):
    """Phase 7's ResNet-50: random weights from seed 0, each block's
    zero gamma drawn from U(0.25, 0.75) (seed 2), fused or not, the
    LogSoftMax tail dropped for ``CrossEntropyCriterion``."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.resnet import build_resnet_imagenet
    from bigdl_tpu_torch.nn.fused import fuse_conv_bn
    from bigdl_tpu_torch.nn.layers import SpatialBatchNormalization

    RandomGenerator.RNG.set_seed(0)
    model = build_resnet_imagenet(50, TRAIN_CLASSES, device=DEV)
    rs = np.random.RandomState(2)
    with torch.no_grad():
        for m in model.modules():
            if (isinstance(m, SpatialBatchNormalization)
                    and not m.weight.abs().max().item()):
                m.weight.copy_(torch.from_numpy(rs.uniform(
                    0.25, 0.75, m.weight.shape).astype(np.float32)))
    if fused:
        fuse_conv_bn(model, kernels=(1, 3))
    model.modules = model.modules[:-1]        # CrossEntropy takes logits
    return model


def _train_arm(fused: bool, x, y):
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    model = _training_resnet50(fused)
    RandomGenerator.RNG.set_seed(1)           # one shuffle order, both arms
    losses = _Losses()
    opt = LocalOptimizer(model, (x, y), CrossEntropyCriterion(),
                         batch_size=TRAIN_BATCH, device=DEV)
    opt.set_optim_method(SGD(learningrate=0.1)).set_compute_dtype("bfloat16")
    opt.set_train_summary(losses)
    # step 1 carries the first launches and cuDNN's plan choices
    opt.set_end_when(Trigger.max_iteration(1)).optimize()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    opt.set_end_when(Trigger.max_iteration(1 + TRAIN_STEPS)).optimize()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / TRAIN_STEPS * 1e3
    launches = dict(_cuda.launches)
    arm = "fused" if fused else "standard"
    loss = [losses.loss[n] for n in sorted(losses.loss)]
    say(f"phase 7 {arm} arm: losses {['%.5f' % v for v in loss]}; step "
        f"{step_ms:.3f} ms over steps 2-{1 + TRAIN_STEPS} "
        f"({TRAIN_BATCH / step_ms * 1e3:.1f} images/s); conv_bn launches "
        f"{launches['conv_bn_1x1']} 1x1, {launches['conv_bn_kxk']} kxk in "
        f"{TRAIN_STEPS} steps")
    if len(loss) != 1 + TRAIN_STEPS or not all(np.isfinite(loss)):
        raise AssertionError(f"{arm} arm: missing or non-finite losses")
    want = (36 * TRAIN_STEPS, 16 * TRAIN_STEPS) if fused else (0, 0)
    if (launches["conv_bn_1x1"], launches["conv_bn_kxk"]) != want:
        raise AssertionError(f"{arm} arm launched conv_bn "
                             f"{launches['conv_bn_1x1']}/"
                             f"{launches['conv_bn_kxk']}, want {want}")
    return opt, loss, step_ms, launches


class _TimedLosses(_Losses):
    """Each step's loss and the host clock when the trainer read it."""

    def __init__(self):
        super().__init__()
        self.at = {}

    def add_scalar(self, tag, value, step):
        super().add_scalar(tag, value, step)
        if tag == "Loss":
            self.at[step] = time.perf_counter()


def steady_step_ms(at: dict, per_epoch: int) -> float:
    """The median gap between two successive loss reads from step 2 on.
    The trainer reads step n's loss after it has queued step n + 1, so
    a gap is one loop period when steps n + 1 and n + 2 are in one
    epoch (an epoch's last read waits on no next step, and validation
    runs after it)."""
    gaps = [at[n + 1] - at[n] for n in sorted(at)
            if n >= 2 and n + 1 in at and (n - 1) % per_epoch <= per_epoch - 3]
    return float(np.median(gaps)) * 1e3


def loss_gaps(std_loss, fused_loss) -> tuple:
    """|loss, fused - standard| by step, and the steps (1-based) where
    it is over its limit."""
    gaps = [abs(f - s) for f, s in zip(fused_loss, std_loss)]
    over = [i + 1 for i, g in enumerate(gaps)
            if not g <= (LOSS_TOL if i == 0 else LATER_LOSS_TOL)]
    return gaps, over


def train_both_arms():
    """ResNet-50 training, standard arm then fused arm, from the same
    weights and data: (fused optimizer, its launches, standard losses,
    fused losses)."""
    x = np.random.RandomState(0).randn(
        TRAIN_BATCH, 3, TRAIN_IMG, TRAIN_IMG).astype(np.float32)
    y = (np.random.RandomState(1).randint(0, TRAIN_CLASSES, TRAIN_BATCH)
         + 1).astype(np.float32)
    std, std_loss, std_ms, _ = _train_arm(False, x, y)
    del std
    torch.cuda.empty_cache()
    fused, fused_loss, fused_ms, launches = _train_arm(True, x, y)
    say(f"phase 7 step ms standard {std_ms:.3f}, fused {fused_ms:.3f}")
    return fused, launches, std_loss, fused_loss


def phase_training():
    """Both arms; returns the fused arm's optimizer and its launches."""
    fused, launches, std_loss, fused_loss = train_both_arms()
    gaps, over = loss_gaps(std_loss, fused_loss)
    say(f"phase 7 first-step loss: standard {std_loss[0]:.6f}, fused "
        f"{fused_loss[0]:.6f}; |gap| by step "
        f"{['%.3e' % g for g in gaps]} (limit {LOSS_TOL:g} at step 1, "
        f"{LATER_LOSS_TOL:g} later)")
    if over:
        raise AssertionError(f"fused and standard losses differ by more "
                             f"than their limit at steps {over}")
    return fused, launches


def phase_train_profile(opt, phase: int = 8,
                        what: str = "fused training step") -> None:
    """Device busy share and top kernels over two training steps of
    ``opt``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.optim import Trigger

    steps = 2
    n = opt.state["neval"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        opt.set_end_when(Trigger.max_iteration(n - 1 + steps)).optimize()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.self_device_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy_ms = sum(r[0] for r in rows)
    # the host side: ops by self CPU time (the profiler's own cost
    # inflates these; their order is what they show)
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), reverse=True)
    say(f"phase {phase} profile host: {sum(h[1] for h in host) // steps} host "
        "ops per step; top by self CPU time:")
    for ms, cnt, key in host[:8]:
        say(f"phase {phase} profile host: {ms / steps:8.3f} ms/step  "
            f"x{cnt // steps:<5d} {key[:80]}")
    if not rows:
        say(f"phase {phase} profile: the profiler shows no device time (device "
            f"busy share not measured); wall {wall_ms / steps:.3f} ms per "
            "step")
        return
    say(f"phase {phase} profile: {wall_ms / steps:.3f} ms per {what} "
        f"(wall), device busy {busy_ms / steps:.3f} ms per step, busy share "
        f"{busy_ms / wall_ms:.3f}")
    # the ten largest, then the port's own kernels (csrc/) below them
    ours = [r for r in rows[10:] if PORT_KERNEL.match(r[2])]
    for ms, cnt, key in rows[:10] + ours:
        say(f"phase {phase} profile:   {ms / steps:8.4f} ms/step  "
            f"x{cnt // steps:<4d} {key[:90]}")


def _bwd_limit(ref: torch.Tensor) -> float:
    mag = ref.float().abs().max().item()
    return (BWD_F32_REL * mag if ref.dtype == torch.float32
            else _bf16_ulp(mag))


def _flash_bwd_inputs(case, gen):
    """Flat q, k, v, g of one case, its forward's out and lse, and δ."""
    from bigdl_tpu_torch.ops.attention import _flash_forward

    b, h, tq, tk, d, dt, causal = case
    q, g = (torch.randn((b * h, tq, d), generator=gen, device=DEV).to(dt)
            for _ in range(2))
    k, v = (torch.randn((b * h, tk, d), generator=gen, device=DEV).to(dt)
            for _ in range(2))
    out, lse = _flash_forward(q, k, v, causal=causal, scale=d ** -0.5,
                              with_lse=True)
    delta = (g.float() * out.float()).sum(dim=-1)
    return q, k, v, g, out, lse, delta


def _flash_bwd_case(case, gen):
    """Both kernels (through ``flash_backward``, twice: bit-equal)
    against the plain versions: the max abs errors of dq, dk, dv."""
    from bigdl_tpu_torch.ops.attention import (flash_backward,
                                               flash_bwd_dkv_plain,
                                               flash_bwd_dq_plain)

    b, h, tq, tk, d, dt, causal = case
    scale = d ** -0.5
    q, k, v, g, out, lse, delta = _flash_bwd_inputs(case, gen)
    got = flash_backward(q, k, v, out, lse, g, causal=causal, scale=scale)
    again = flash_backward(q, k, v, out, lse, g, causal=causal, scale=scale)
    torch.cuda.synchronize()
    name = (f"flash backward B={b} H={h} Tq={tq} Tk={tk} D={d} "
            f"{str(dt)[6:]} causal={causal}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        raise AssertionError(f"{name}: two runs on one input differ")
    want = (flash_bwd_dq_plain(q, k, v, g, lse, delta, causal=causal,
                               scale=scale),
            *flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal=causal,
                                 scale=scale))
    errs = []
    for which, x, w in zip(("dq", "dk", "dv"), got, want):
        if x.dtype != dt:
            raise AssertionError(f"{name}: {which} is {x.dtype}")
        err = (x.float() - w.float()).abs().max().item()
        check(f"{name} {which}", err, _bwd_limit(w))
        errs.append(err)
    say(f"phase 10 {name}: max abs err dq {errs[0]:.3e}, dk {errs[1]:.3e}, "
        f"dv {errs[2]:.3e}; bit-equal run to run")
    return errs


def _flash_bwd_times(case, gen, plain: bool = True) -> dict:
    """Times at one shape: each kernel, its bound, achieved TFLOP/s and
    share of the bound, δ, the backward of scaled_dot_product_attention
    and, if ``plain``, the plain versions."""
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.ops.attention import (flash_bwd_dkv_plain,
                                               flash_bwd_dq_plain)

    b, h, tq, tk, d, dt, causal = case
    scale = d ** -0.5
    q, k, v, g, out, lse, delta = _flash_bwd_inputs(case, gen)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    kw = dict(causal=causal, scale=scale)
    t = dict(
        dq=time_ms(lambda: _cuda.launch_flash_bwd_dq(q, k, v, g, lse, delta,
                                                     dq, **kw)),
        dkv=time_ms(lambda: _cuda.launch_flash_bwd_dkv(
            q, k, v, g, lse, delta, dk, dv, **kw)),
        delta=time_ms(lambda: (g.float() * out.float()).sum(dim=-1)))
    if plain:
        t["dq_plain"] = time_ms(lambda: flash_bwd_dq_plain(
            q, k, v, g, lse, delta, **kw))
        t["dkv_plain"] = time_ms(lambda: flash_bwd_dkv_plain(
            q, k, v, g, lse, delta, **kw))
    q4, k4, v4 = (x.reshape(b, h, -1, d).detach().requires_grad_()
                  for x in (q, k, v))
    o4 = torch.nn.functional.scaled_dot_product_attention(
        q4, k4, v4, is_causal=causal)
    g4 = g.reshape(b, h, tq, d)
    t["sdpa_bwd"] = time_ms(lambda: torch.autograd.grad(
        o4, (q4, k4, v4), g4, retain_graph=True))
    bh, item = b * h, q.element_size()
    # the (q, k) pairs the causal mask keeps (timed shapes have Tq = Tk)
    pairs = bh * (tq * (tq + 1) / 2 if causal else tq * tk)
    rows = 2 * bh * tq * 4                       # lse and δ read
    # dq: q, g, k, v read, dq written; dkv: q, g, k, v read, dk, dv written
    t["dq_bound"] = bound((3 * bh * tq * d + 2 * bh * tk * d) * item + rows,
                          6 * d * pairs, dt)
    t["dkv_bound"] = bound((2 * bh * tq * d + 4 * bh * tk * d) * item + rows,
                           8 * d * pairs, dt)
    parts = []
    for key, per_pair in (("dq", 6), ("dkv", 8)):
        # the algorithm's FLOPs, not the hi/lo split's extra products
        t[f"{key}_tflops"] = per_pair * d * pairs / (t[key] * 1e-3) / 1e12
        t[f"{key}_of_bound"] = t[f"{key}_bound"][0] / t[key]
        plain_ms = (f"plain {t[key + '_plain']:.4f}, " if plain
                    else "plain not timed, ")
        parts.append(
            f"{key} kernel {t[key]:.4f} ms ({plain_ms}bound "
            f"{t[key + '_bound'][0]:.5f} by {t[key + '_bound'][1]}, "
            f"{t[key + '_tflops']:.1f} TFLOP/s, "
            f"{t[key + '_of_bound']:.3f} of the bound)")
    say(f"phase 10 time B={b} H={h} T={tq} D={d} {str(dt)[6:]}: "
        f"{'; '.join(parts)}; delta {t['delta']:.4f} ms; dq + dkv + delta "
        f"{t['dq'] + t['dkv'] + t['delta']:.4f} ms against the SDPA backward "
        f"{t['sdpa_bwd']:.4f} ms")
    return t


def phase_flash_bwd(gen) -> list:
    """Phase 10: both backward kernels at every case, times at the
    training shape; returns their two kernels-line rows."""
    worst = {torch.float32: [0.0] * 3, torch.bfloat16: [0.0] * 3}
    for case in FLASH_BWD_CASES:
        errs = _flash_bwd_case(case, gen)
        worst[case[5]] = [max(a, e) for a, e in zip(worst[case[5]], errs)]
    times = {case[5]: _flash_bwd_times(case, gen)
             for case in FLASH_BWD_CASES[:2]}
    long = _flash_bwd_times(FLASH_BWD_CASES[2], gen, plain=False)
    main = times[torch.bfloat16]
    shape = "B=16 H=8 T=512 D=64 bf16 causal"
    sdpa = ("scaled_dot_product_attention backward (dq, dk, dv together), "
            "against the sum of both kernels plus delta: "
            f"{main['dq'] + main['dkv'] + main['delta']:.4f} ms")
    rows = []
    for name, src, replaces, err, err16 in (
            ("flash_bwd_dq", "flash_bwd_dq.cu", DQ_REPLACES,
             worst[torch.float32][0], worst[torch.bfloat16][0]),
            ("flash_bwd_dkv", "flash_bwd_dkv.cu", DKV_REPLACES,
             max(worst[torch.float32][1:]), max(worst[torch.bfloat16][1:]))):
        key = name[len("flash_bwd_"):]
        f32 = times[torch.float32]
        rows.append(dict(
            name=name, route="cuda", source=f"bigdl_tpu_torch/csrc/{src}",
            replaces=replaces, max_abs_err=err, max_abs_err_bf16=err16,
            ms=main[key], plain_ms=main[f"{key}_plain"],
            bound_ms=main[f"{key}_bound"][0],
            bound_by=main[f"{key}_bound"][1], library_ms=main["sdpa_bwd"],
            library=sdpa, shape=shape, tflops=main[f"{key}_tflops"],
            f32_ms=f32[key], f32_plain_ms=f32[f"{key}_plain"],
            f32_bound_ms=f32[f"{key}_bound"][0],
            f32_library_ms=f32["sdpa_bwd"],
            long_shape="B=2 H=8 T=4096 D=64 bf16 causal", long_ms=long[key],
            long_bound_ms=long[f"{key}_bound"][0],
            long_tflops=long[f"{key}_tflops"],
            long_library_ms=long["sdpa_bwd"]))
    return rows


def _lm(impl: str, max_len: int, remat: bool = False):
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.transformer import build_transformer_lm

    RandomGenerator.RNG.set_seed(0)
    return build_transformer_lm(LM_VOCAB, max_len=max_len, attn_impl=impl,
                                remat=remat, device=DEV, **LM)


def _lm_data(batch: int, t: int):
    """int32 token ids as bench.py:442-445 draws them, and 1-based
    targets for CrossEntropyCriterion."""
    rs = np.random.RandomState(0)
    return (rs.randint(0, LM_VOCAB, (batch, t)).astype(np.int32),
            (rs.randint(0, LM_VOCAB, (batch, t)) + 1).astype(np.int32))


def _lm_grads(impl: str, x, y):
    """One step's f32 gradient of every parameter, by name."""
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion

    model = _lm(impl, LM_T)
    model.train()
    named = list(model.named_parameters())
    loss = CrossEntropyCriterion().loss(
        model(torch.as_tensor(x, device=DEV)).float(),
        torch.as_tensor(y, device=DEV))
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return loss.item(), {n: gr for (n, _), gr in zip(named, grads)}


def _lm_train_arm(impl: str, x, y, steps: int, max_len: int = LM_T,
                  remat: bool = False):
    """``LocalOptimizer`` under the bf16 policy: step 1, then ``steps``
    timed steps.  Returns (optimizer, losses, step ms, launches of the
    timed steps)."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    model = _lm(impl, max_len, remat)
    RandomGenerator.RNG.set_seed(1)           # one shuffle order, both arms
    losses = _Losses()
    opt = LocalOptimizer(model, (x, y), CrossEntropyCriterion(),
                         batch_size=x.shape[0], device=DEV)
    opt.set_optim_method(SGD(learningrate=1e-3)).set_compute_dtype("bfloat16")
    opt.set_train_summary(losses)
    opt.set_end_when(Trigger.max_iteration(1)).optimize()
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    opt.set_end_when(Trigger.max_iteration(1 + steps)).optimize()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / steps * 1e3
    launches = {k: _cuda.launches[k]
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    loss = [losses.loss[n] for n in sorted(losses.loss)]
    if len(loss) != 1 + steps or not all(np.isfinite(loss)):
        raise AssertionError(f"{impl} arm: missing or non-finite losses "
                             f"{loss}")
    return opt, loss, step_ms, launches


def phase_long_context() -> None:
    """Phase 11's long-context point: the kernel arm at B=2, T=4096 with
    remat, step 2 timed (16/8/8 launches), then two steps under the
    profiler for the step's device time."""
    lx, ly = _lm_data(LONG_BATCH, LONG_T)
    torch.cuda.reset_peak_memory_stats()
    long_opt, loss, ms, long_launches = _lm_train_arm(
        "kernel", lx, ly, 1, max_len=LONG_T, remat=True)
    say(f"phase 11 long context B={LONG_BATCH} T={LONG_T} remat, bf16: "
        f"losses {['%.5f' % v for v in loss]}; step 2 {ms:.3f} ms "
        f"({LONG_BATCH * LONG_T / ms * 1e3:.1f} tokens/s); launches "
        f"{long_launches} in step 2; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if tuple(long_launches.values()) != (16, 8, 8):
        raise AssertionError(f"long-context step launched {long_launches}, "
                             "want (16, 8, 8) (fwd, dq, dkv)")
    phase_train_profile(long_opt, 11, "long-context step")
    del long_opt
    torch.cuda.empty_cache()


def phase_lm_training():
    """Phase 11: the f32 gradient check, the long-context point, then
    the transformer's two arms.  Returns the kernel arm's optimizer and
    its launches."""
    x, y = _lm_data(LM_BATCH, LM_T)
    ref_loss, ref = _lm_grads("reference", x, y)
    torch.cuda.empty_cache()
    ker_loss, ker = _lm_grads("kernel", x, y)
    # relative L2 per tensor; a key bias's exact gradient is 0 (each
    # query's softmax is unchanged by a shift common to all its keys), so
    # its rounding noise is measured against the same layer's query-bias
    # gradient instead
    rel = {n: ((ker[n] - ref[n]).norm()
               / ref[n[:-2] + "bq" if n.endswith(".bk") else n].norm()).item()
           for n in ref}
    worst = max(rel, key=rel.get)
    dead = [n for n in ker if n.split(".")[-1] in ("wq", "wk", "wv")
            and not ker[n].abs().max().item()]
    say(f"phase 11 (a) f32 gradients of {len(rel)} tensors: loss reference "
        f"{ref_loss:.6f}, kernel {ker_loss:.6f}; worst relative L2 "
        f"{rel[worst]:.3e} at {worst} (limit {LM_GRAD_REL_TOL:g}); "
        f"zero wq/wk/wv gradients: {len(dead)}")
    if not rel[worst] <= LM_GRAD_REL_TOL or dead:
        raise AssertionError(f"kernel-arm gradients off: {worst} "
                             f"{rel[worst]:.3e}, zero {dead}")
    del ref, ker
    torch.cuda.empty_cache()

    # the long-context point before the arms, so that the kernel arm's
    # optimizer goes to phase 12's profile with its allocator cache warm
    phase_long_context()

    arms = {}
    for impl in ("reference", "kernel"):
        opt, loss, ms, launches = _lm_train_arm(impl, x, y, LM_STEPS)
        tokens = LM_BATCH * LM_T / ms * 1e3
        say(f"phase 11 (b) {impl} arm, bf16: losses "
            f"{['%.5f' % v for v in loss]}; step {ms:.3f} ms over steps "
            f"2-{1 + LM_STEPS} ({tokens:.1f} tokens/s); launches {launches} "
            f"in {LM_STEPS} steps")
        want = (8 * LM_STEPS if impl == "kernel" else 0,) * 3
        if tuple(launches.values()) != want:
            raise AssertionError(f"{impl} arm launched {launches}, want "
                                 f"{want} (fwd, dq, dkv)")
        arms[impl] = (loss, launches)
        _LM_SGD_MS[impl] = ms
        if impl == "reference":
            del opt
            torch.cuda.empty_cache()
    gaps = [abs(a - b) for a, b in zip(arms["kernel"][0],
                                       arms["reference"][0])]
    say(f"phase 11 (b) |loss, kernel - reference| by step "
        f"{['%.3e' % g for g in gaps]} (limit {LM_LOSS_TOL:g})")
    if not all(gp <= LM_LOSS_TOL for gp in gaps):
        raise AssertionError("the arms' bf16 losses differ by more than "
                             f"{LM_LOSS_TOL}")
    launches = arms["kernel"][1]
    return opt, launches


def _ptb_data():
    """The BPTT windows of bench.py's PTB config: (x, y) of (15·64, 20)
    1-based float ids."""
    from bigdl_tpu_torch.dataset.text import (ptb_bptt_batches,
                                              synthetic_ptb_stream)

    stream = synthetic_ptb_stream(n_tokens=PTB_TOKENS, vocab_size=PTB_VOCAB)
    xs, ys = ptb_bptt_batches(stream, PTB_BATCH, PTB_T)
    return xs.reshape(-1, PTB_T), ys.reshape(-1, PTB_T)


def _ptb_run(device, x, y):
    """One epoch of the PTB LM on ``device`` from the seed-0 weights and
    the seed-1 shuffle: (optimizer, losses, perplexity before, after;
    the perplexities on the card only)."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.rnn import (PTB_CLIP_NORM, build_ptb_lm,
                                            perplexity)
    from bigdl_tpu_torch.nn import ClassNLLCriterion, TimeDistributedCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    RandomGenerator.RNG.set_seed(0)
    model = build_ptb_lm(PTB_VOCAB, embed_size=PTB_EMBED,
                         hidden_size=PTB_HIDDEN, device=device)
    on_card = device == DEV
    before = perplexity(model, x, y, PTB_BATCH, device) if on_card else None
    RandomGenerator.RNG.set_seed(1)
    losses = _TimedLosses()
    opt = LocalOptimizer(model, (x, y), TimeDistributedCriterion(
        ClassNLLCriterion(), size_average=True), batch_size=PTB_BATCH,
        device=device)
    opt.set_optim_method(SGD(learningrate=0.1))
    opt.set_end_when(Trigger.max_epoch(1)).set_train_summary(losses)
    opt.set_gradient_clipping_by_l2_norm(PTB_CLIP_NORM)
    opt.optimize()
    after = perplexity(model, x, y, PTB_BATCH, device) if on_card else None
    return opt, losses, before, after


def _gru_gap() -> list:
    """A ``Recurrent(GRU(128, 256))`` forward and its input gradient on
    the card against the CPU: relative L2 of each."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.nn import GRU, Recurrent

    RandomGenerator.RNG.set_seed(3)
    layer = Recurrent().add(GRU(PTB_EMBED, PTB_HIDDEN))
    x = np.random.RandomState(4).randn(PTB_BATCH, PTB_T, PTB_EMBED).astype(
        np.float32)
    r = np.random.RandomState(5).randn(PTB_BATCH, PTB_T, PTB_HIDDEN).astype(
        np.float32)
    res = {}
    for dev in (DEV, "cpu"):
        layer.to(dev)
        xt = torch.tensor(x, device=dev, requires_grad=True)
        out = layer(xt)
        (gx,) = torch.autograd.grad(
            (out * torch.as_tensor(r, device=dev)).sum(), [xt])
        res[dev] = (out.detach().cpu(), gx.cpu())
    return [((a - b).norm() / b.norm()).item()
            for a, b in zip(res[DEV], res["cpu"])]


def phase_ptb() -> None:
    """Phase 13: the PTB LM's epoch on the card and on the CPU, the GRU
    check, then two profiled steps."""
    from bigdl_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    x, y = _ptb_data()
    kernels_before = _model_launches()
    torch.cuda.synchronize()
    opt, losses, ppl0, ppl1 = _ptb_run(DEV, x, y)
    torch.cuda.synchronize()
    steps = x.shape[0] // PTB_BATCH
    loss = [losses.loss[n] for n in sorted(losses.loss)]
    step_ms = steady_step_ms(losses.at, steps)
    t0 = time.perf_counter()
    _, cpu_losses, _, _ = _ptb_run("cpu", x, y)
    cpu_s = time.perf_counter() - t0
    cpu = [cpu_losses.loss[n] for n in sorted(cpu_losses.loss)]
    rel = [abs(a - b) / abs(b) for a, b in zip(loss, cpu)]
    say(f"phase 13 PTB LM vocab {PTB_VOCAB}, embed {PTB_EMBED}, LSTM "
        f"{PTB_HIDDEN}, batch {PTB_BATCH}, T {PTB_T}, f32: {len(loss)} "
        f"steps, losses {['%.5f' % v for v in loss]}; perplexity "
        f"{ppl0:.3f} -> {ppl1:.3f}")
    say(f"phase 13 step {step_ms:.3f} ms (median, wall), "
        f"{PTB_BATCH * PTB_T / step_ms * 1e3:.1f} tokens/s; card "
        f"against CPU ({cpu_s:.1f} s) worst relative loss gap "
        f"{max(rel):.3e} at step {int(np.argmax(rel)) + 1} (limit "
        f"{PTB_LOSS_REL_TOL:g})")
    if len(loss) != steps or len(cpu) != steps or not all(np.isfinite(loss)):
        raise AssertionError(f"PTB LM: missing or non-finite losses {loss}")
    if not max(rel) <= PTB_LOSS_REL_TOL:
        raise AssertionError(f"PTB LM losses off the CPU run's: {rel}")
    if not ppl1 < ppl0:
        raise AssertionError(f"perplexity did not fall: {ppl0} -> {ppl1}")
    if _model_launches() != kernels_before:
        raise AssertionError("the PTB LM launched a kernel of csrc/")
    gru = _gru_gap()
    say(f"phase 13 Recurrent(GRU({PTB_EMBED}, {PTB_HIDDEN})) card against "
        f"CPU: relative L2 output {gru[0]:.3e}, input gradient {gru[1]:.3e} "
        f"(limit {GRU_REL_TOL:g})")
    if not max(gru) <= GRU_REL_TOL:
        raise AssertionError(f"GRU off the CPU's: {gru}")
    phase_train_profile(opt, 13, "PTB LM step")
    say(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")


class _Scalars:
    """The validation summary: (tag, neval, value) rows."""

    def __init__(self):
        self.rows = []

    def add_scalar(self, tag, value, step):
        self.rows.append((tag, step, value))


def _lenet_run(device, steps=None):
    """``train_lenet``'s recipe through the ``Optimizer`` factory:
    ``LENET_EPOCHS`` epochs with validation every epoch, or ``steps``
    steps without it.  Returns (model, test set, losses, validations)."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.dataset.mnist import load_mnist, normalize
    from bigdl_tpu_torch.models.lenet import build_lenet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import (SGD, Loss, Optimizer, Top1Accuracy,
                                       Trigger)

    RandomGenerator.RNG.set_seed(0)
    model = build_lenet5(device=device)
    x, y = load_mnist(None, "train", synthetic_n=LENET_N)
    tx, ty = load_mnist(None, "test", synthetic_n=LENET_N)
    test_ds = ArrayDataSet(normalize(tx), ty, LENET_BATCH)
    opt = Optimizer(model=model, training_set=ArrayDataSet(
        normalize(x), y, LENET_BATCH), criterion=ClassNLLCriterion(),
        batch_size=LENET_BATCH, device=device)
    losses, vals = _TimedLosses(), _Scalars()
    opt.set_optim_method(SGD(learningrate=LENET_LR))
    opt.set_train_summary(losses).set_val_summary(vals)
    if steps:
        opt.set_end_when(Trigger.max_iteration(steps))
    else:
        opt.set_end_when(Trigger.max_epoch(LENET_EPOCHS)).set_validation(
            Trigger.every_epoch(), test_ds, [Top1Accuracy(), Loss()])
    RandomGenerator.RNG.set_seed(1)
    opt.optimize()
    return model, test_ds, losses, vals


def phase_lenet() -> None:
    """Phase 14: LeNet-5 with validation on the card, its first losses
    and its evaluation against the CPU's."""
    from bigdl_tpu_torch.models.lenet import build_lenet5
    from bigdl_tpu_torch.optim import Loss, Top1Accuracy, evaluate_dataset

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    model, test_ds, losses, vals = _lenet_run(DEV)
    torch.cuda.synchronize()
    per_epoch = LENET_N // LENET_BATCH
    loss = [losses.loss[n] for n in sorted(losses.loss)]
    step_ms = steady_step_ms(losses.at, per_epoch)
    top1 = [v for t, _, v in vals.rows if t == "Top1Accuracy"]
    val_loss = [v for t, _, v in vals.rows if t == "Loss"]
    _, _, cpu_losses, _ = _lenet_run("cpu", steps=3)
    cpu = [cpu_losses.loss[n] for n in sorted(cpu_losses.loss)]
    rel = [abs(a - b) / abs(b) for a, b in zip(loss, cpu)]
    cpu_model = build_lenet5(device="cpu")
    cpu_model.set_params(model.params())
    t0 = time.perf_counter()
    card_eval = evaluate_dataset(model, test_ds, [Top1Accuracy(), Loss()],
                                 DEV)
    eval_ms = (time.perf_counter() - t0) * 1e3
    cpu_eval = evaluate_dataset(cpu_model, test_ds, [Top1Accuracy(), Loss()],
                                "cpu")
    loss_gap = abs(card_eval[1].result()[0] - cpu_eval[1].result()[0])
    say(f"phase 14 LeNet-5, {LENET_N} train / {LENET_N} test, batch "
        f"{LENET_BATCH}, lr {LENET_LR}: {len(loss)} steps, validation Top1 "
        f"by epoch {['%.4f' % v for v in top1]}, Loss "
        f"{['%.5f' % v for v in val_loss]}; step {step_ms:.3f} ms (median, "
        f"wall), {LENET_BATCH / step_ms * 1e3:.1f} images/s")
    say(f"phase 14 first losses card {['%.6f' % v for v in loss[:3]]}, CPU "
        f"{['%.6f' % v for v in cpu]}, worst relative gap {max(rel):.3e} "
        f"(limit {LENET_LOSS_REL_TOL:g}); evaluate_dataset card "
        f"({eval_ms:.1f} ms) against CPU: Top1 {card_eval[0].total:.0f} / "
        f"{cpu_eval[0].total:.0f} of {card_eval[0].count}, Loss gap "
        f"{loss_gap:.3e} (limit {LENET_EVAL_LOSS_TOL:g})")
    if len(loss) != LENET_EPOCHS * per_epoch or not all(np.isfinite(loss)):
        raise AssertionError(f"LeNet-5: missing or non-finite losses {loss}")
    if len(top1) != LENET_EPOCHS or not top1[-1] >= LENET_TOP1_MIN:
        raise AssertionError(f"LeNet-5 validation Top1 {top1}")
    if len(cpu) != 3 or not max(rel) <= LENET_LOSS_REL_TOL:
        raise AssertionError(f"LeNet-5 losses off the CPU run's: {rel}")
    if card_eval[0].total != cpu_eval[0].total or not (
            loss_gap <= LENET_EVAL_LOSS_TOL):
        raise AssertionError("evaluate_dataset differs between the card and "
                             "the CPU")
    say(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")


# ---- phase 15: ResNet-50 from an image folder through DistriOptimizer ----
def _write_image_folder(root: str) -> int:
    """``root/{train,val}/n{class}/*.bmp`` from seed 0: a class pattern
    plus noise, 240x300 to 300x240 pixels; returns the bytes written."""
    from bigdl_tpu_torch.transform.vision import write_bmp

    rs = np.random.RandomState(0)
    total = 0
    for split, per_class in (("train", IMG_TRAIN), ("val", IMG_VAL)):
        for c in range(IMG_CLASSES):
            d = os.path.join(root, split, f"n{c:08d}")
            os.makedirs(d)
            for i in range(per_class):
                h = int(rs.randint(240, 301))
                w = 540 - h
                yy, xx = np.mgrid[0:h, 0:w]
                base = np.stack([(xx * (c + 1)) % 256, (yy * (c + 2)) % 256,
                                 ((xx + yy) * (c + 3)) % 256], axis=-1)
                img = np.clip(base + rs.randint(-40, 41, (h, w, 3)), 0, 255)
                path = os.path.join(d, f"img{i:03d}.bmp")
                write_bmp(path, img.astype(np.uint8))
                total += os.path.getsize(path)
    return total


class _Recorder(_TimedLosses):
    """Each step's loss (and when it was read) and each validation."""

    def __init__(self):
        super().__init__()
        self.val = []

    def add_scalar(self, tag, value, step):
        super().add_scalar(tag, value, step)
        if tag not in ("Loss", "Throughput"):
            self.val.append((tag, step, value))


def _imagenet_entry_point(root: str, ck: str):
    """(a): ``resnet.main -f`` on the card, its optimizer recording into
    a ``_Recorder``; returns (optimizer, recorder, validation log lines,
    seconds)."""
    import logging

    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models import resnet
    from bigdl_tpu_torch.optim import distri_optimizer as D

    rec = _Recorder()
    base = D.DistriOptimizer

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.set_train_summary(rec).set_val_summary(rec)

    lines = []

    class Lines(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    handler = Lines(level=logging.INFO)
    logger = logging.getLogger("bigdl_tpu_torch.optim")
    logger.addHandler(handler)
    old_level = logger.level
    logger.setLevel(logging.INFO)
    D.DistriOptimizer = Recording
    try:
        RandomGenerator.RNG.set_seed(0)
        t0 = time.perf_counter()
        opt = resnet.main(["-f", root, "--depth", "50", "-b",
                           str(IMG_BATCH), "-e", str(IMG_EPOCHS),
                           "--image-size", str(IMG_SIZE), "--checkpoint", ck,
                           "--device", DEV])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        D.DistriOptimizer = base
        logger.removeHandler(handler)
        logger.setLevel(old_level)
    return opt, rec, [m for m in lines if m.startswith("validation ")], secs


def _check_entry_point(opt, rec, val_lines, ck: str) -> None:
    from bigdl_tpu_torch.models.resnet import build_resnet_imagenet
    from bigdl_tpu_torch.utils import serializer as S
    from bigdl_tpu_torch.utils import tree as T

    per_epoch = IMG_CLASSES * IMG_TRAIN // IMG_BATCH
    loss = [rec.loss[n] for n in sorted(rec.loss)]
    if len(loss) != IMG_EPOCHS * per_epoch or not all(np.isfinite(loss)):
        raise AssertionError(f"entry point: missing or non-finite losses "
                             f"{loss}")
    for name in ("Top1Accuracy", "Top5Accuracy"):
        got = [v for t, _, v in rec.val if t == name]
        printed = [m for m in val_lines if m.startswith(f"validation {name}")]
        if len(got) != IMG_EPOCHS or len(printed) != IMG_EPOCHS:
            raise AssertionError(f"{name}: {len(got)} validations, "
                                 f"{len(printed)} printed")
    if opt.state["neval"] != IMG_EPOCHS * per_epoch + 1:
        raise AssertionError(f"neval {opt.state['neval']}")
    prefixes = S.checkpoint_prefixes(ck)
    if len(prefixes) != IMG_EPOCHS:
        raise AssertionError(f"checkpoints {prefixes}")
    for p in prefixes:
        ok, reason = S.verify_checkpoint(os.path.join(ck, p))
        if not ok:
            raise AssertionError(f"{p}: {reason}")
    last = os.path.join(ck, f"checkpoint_{IMG_EPOCHS + 1}_"
                            f"{IMG_EPOCHS * per_epoch + 1}")
    cpu = build_resnet_imagenet(50, IMG_CLASSES, device="cpu")
    S.load_checkpoint(last, cpu)
    unequal = [i for i, (a, b) in enumerate(zip(
        T.leaves(cpu.params()), T.leaves(opt.model.params())))
        if not torch.equal(a, b.detach().cpu())]
    unequal += [f"s{i}" for i, (a, b) in enumerate(zip(
        T.leaves(cpu.state()), T.leaves(opt.model.state())))
        if not torch.equal(a, b.detach().cpu())]
    if unequal or S.read_checkpoint_topology(last)["step"] != \
            opt.state["neval"]:
        raise AssertionError(f"epoch-{IMG_EPOCHS} checkpoint differs from "
                             f"the trained model at leaves {unequal[:8]}")


def _retry_runs(ck: str):
    """(b): ResNet-50 on 64 synthetic images, shuffle off, 3 epochs,
    uninterrupted and with a RuntimeError at the first step of epoch 2
    (checkpoints into ``ck``).  Returns (reference, retried)
    optimizers."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.models.resnet import build_resnet_imagenet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger

    rs = np.random.RandomState(3)
    x = rs.randn(RETRY_N, 3, IMG_SIZE, IMG_SIZE).astype(np.float32)
    y = (rs.randint(0, IMG_CLASSES, RETRY_N) + 1).astype(np.float32)
    per_epoch = RETRY_N // IMG_BATCH
    fail_at = per_epoch + 1
    runs = []
    for inject in (False, True):
        RandomGenerator.RNG.set_seed(0)
        model = build_resnet_imagenet(50, IMG_CLASSES, device=DEV)
        opt = DistriOptimizer(model, ArrayDataSet(x, y, IMG_BATCH,
                                                  shuffle=False),
                              ClassNLLCriterion(), IMG_BATCH, device=DEV)
        opt.set_optim_method(SGD(learningrate=0.05, momentum=0.9))
        opt.set_end_when(Trigger.max_epoch(RETRY_EPOCHS))
        if inject:
            opt.set_checkpoint(ck, Trigger.every_epoch())
            armed = {"on": True}
            put = opt._put_batch

            def poisoned(inp, tgt, mask, opt=opt, put=put, armed=armed):
                if armed["on"] and opt.state["neval"] == fail_at:
                    armed["on"] = False
                    raise RuntimeError("injected failure")
                return put(inp, tgt, mask)

            opt._put_batch = poisoned
        opt.optimize()
        runs.append(opt)
    return runs


def _check_retry(ref, opt) -> None:
    from bigdl_tpu_torch.utils import tree as T

    want = RETRY_EPOCHS * (RETRY_N // IMG_BATCH) + 1
    if opt.retries != 1 or opt.state["neval"] != want:
        raise AssertionError(f"retry: {opt.retries} reloads, neval "
                             f"{opt.state['neval']} (want 1, {want})")
    pairs = list(zip(T.leaves(opt.model.params()),
                     T.leaves(ref.model.params())))
    pairs += list(zip(T.leaves(opt.model.state()),
                      T.leaves(ref.model.state())))
    unequal = [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)]
    if unequal:
        raise AssertionError(f"retried run differs from the uninterrupted "
                             f"one at {len(unequal)} leaves")


def _trainer_arm(cls, fused: bool, x, y):
    """(c): ``DISTRI_STEPS`` steps of phase 7's ResNet-50 by ``cls``
    (``LocalOptimizer`` or ``DistriOptimizer`` at world 1); the fused
    arm in bf16 with the bf16 wire, the standard one in f32 with the
    f32 wire.  Returns (losses, params, launches)."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.optim import DistriOptimizer, SGD, Trigger
    from bigdl_tpu_torch.utils import tree as T

    model = _training_resnet50(fused)
    RandomGenerator.RNG.set_seed(1)
    kw = dict(wire_dtype="bfloat16" if fused else "float32") \
        if cls is DistriOptimizer else {}
    opt = cls(model, (x, y), CrossEntropyCriterion(), TRAIN_BATCH,
              device=DEV, **kw)
    opt.set_optim_method(SGD(learningrate=0.1))
    if fused:
        opt.set_compute_dtype("bfloat16")
    losses = _Losses()
    opt.set_train_summary(losses)
    opt.set_end_when(Trigger.max_iteration(DISTRI_STEPS))
    torch.cuda.synchronize()
    _cuda.reset_launches()
    opt.optimize()
    torch.cuda.synchronize()
    out = ([losses.loss[n] for n in sorted(losses.loss)],
           [p.detach().float() for p in T.leaves(model.params())],
           dict(_cuda.launches))
    del opt, model
    torch.cuda.empty_cache()
    return out


def _gaps(run, ref):
    """(worst relative loss gap, params relative L2) of two
    ``_trainer_arm`` results."""
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(run[0], ref[0]))
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in zip(run[1], ref[1]))
    den = sum(float(torch.sum(b ** 2)) for b in ref[1])
    return loss_rel, (num / den) ** 0.5


def _distri_vs_local(fused: bool, x, y):
    """(c): the same steps by ``LocalOptimizer`` and by
    ``DistriOptimizer``.  Returns (local losses, distri losses, the
    relative L2 gap of the params, the distri run's launches)."""
    from bigdl_tpu_torch.optim import DistriOptimizer, LocalOptimizer

    local = _trainer_arm(LocalOptimizer, fused, x, y)
    distri = _trainer_arm(DistriOptimizer, fused, x, y)
    return local[0], distri[0], _gaps(distri, local)[1], distri[2]


class _PageableFeed:
    """(d): a trainer mixin whose feed hands over pageable batches, so
    the step copies them blocking; the same steps otherwise."""

    def _host_batches(self, pin):
        return super()._host_batches(False)


def _copy_ab(x, y) -> dict:
    """(d): the same DistriOptimizer steps with the batches copied from
    pageable memory and from pinned memory, in the order pinned,
    pageable, pageable, pinned; median step ms of each run."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.models.resnet import build_resnet_imagenet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger

    class PageableDistri(_PageableFeed, DistriOptimizer):
        pass

    RandomGenerator.RNG.set_seed(0)
    model = build_resnet_imagenet(50, IMG_CLASSES, device=DEV)
    per_epoch = x.shape[0] // IMG_BATCH
    times = {"pinned": [], "pageable": []}
    for arm in ("pinned", "pageable", "pageable", "pinned"):
        cls = DistriOptimizer if arm == "pinned" else PageableDistri
        opt = cls(model, ArrayDataSet(x, y, IMG_BATCH), ClassNLLCriterion(),
                  IMG_BATCH, device=DEV)
        opt.set_optim_method(SGD(learningrate=0.01))
        rec = _TimedLosses()
        opt.set_train_summary(rec).set_end_when(Trigger.max_epoch(1))
        opt.optimize()
        times[arm].append(steady_step_ms(rec.at, per_epoch))
    return times


def phase_imagenet(smi: str) -> None:
    """Phase 15: the TrainImageNet path (``resnet.main -f``) on the card
    from a folder of BMPs, the retry, DistriOptimizer against
    LocalOptimizer at world 1, and the input feed's timing."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.dataset.imagenet import ImageFolderDataSet
    from bigdl_tpu_torch.engine import Engine

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase15_")
    try:
        root = os.path.join(tmp, "data")
        nbytes = _write_image_folder(root)
        say(f"phase 15 image folder: {IMG_CLASSES} classes x {IMG_TRAIN} "
            f"train + {IMG_VAL} val BMPs, {nbytes / 2**20:.1f} MiB, written "
            f"in {time.perf_counter() - t_phase:.1f} s")
        ck = os.path.join(tmp, "ck")
        opt, rec, val_lines, secs = _imagenet_entry_point(root, ck)
        _check_entry_point(opt, rec, val_lines, ck)
        per_epoch = IMG_CLASSES * IMG_TRAIN // IMG_BATCH
        loss = [rec.loss[n] for n in sorted(rec.loss)]
        step_ms = steady_step_ms(rec.at, per_epoch)
        waits, wait_s, items = opt.feed_stats
        say(f"phase 15 (a) resnet.main -f DIR --depth 50 -b {IMG_BATCH} -e "
            f"{IMG_EPOCHS} --checkpoint CK: DistriOptimizer world "
            f"{opt.n_shards} on {Engine._state.backend}, wire "
            f"{opt.wire_dtype}; {len(loss)} losses "
            f"{['%.4f' % v for v in loss]}; neval {opt.state['neval']}; "
            f"validation {[(t, '%.4f' % v) for t, _, v in rec.val]}; "
            f"{len(val_lines)} validation lines logged; 2 checkpoints "
            f"verified, the last loads bit-equal into a CPU model; "
            f"{secs:.1f} s in all")
        train_ds = ImageFolderDataSet(root, batch_size=IMG_BATCH,
                                      image_size=IMG_SIZE)
        idx = np.arange(IMG_BATCH)
        decode_ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            train_ds._batch(idx, True)
            decode_ms.append((time.perf_counter() - t0) * 1e3)
        say(f"phase 15 (d) entry point: step {step_ms:.3f} ms (median wall "
            f"gap), {IMG_BATCH / step_ms * 1e3:.1f} images/s; host decode "
            f"{float(np.median(decode_ms)):.1f} ms a batch of {IMG_BATCH} "
            f"({'Pillow' if _has_pillow() else 'numpy'} resize); the last "
            f"epoch's step waited on the prefetch queue for {waits} of "
            f"{items} batches, {wait_s * 1e3:.1f} ms in all [{smi}]")
        del opt
        torch.cuda.empty_cache()

        # (b) and (c) compare runs to the bit or to 1e-5: cuDNN's
        # backward convs are not bit-reproducible by default, and this
        # ResNet's first steps grow a last-bit difference into 1e-3 of
        # the loss by step 3 (f32, on an H100)
        det = (torch.backends.cudnn.deterministic,
               torch.backends.cudnn.benchmark)
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        try:
            ref, retried = _retry_runs(os.path.join(tmp, "retry_ck"))
            _check_retry(ref, retried)
            say(f"phase 15 (b) retry: RuntimeError injected at neval "
                f"{RETRY_N // IMG_BATCH + 1}; {retried.retries} reload, "
                f"neval {retried.state['neval']}, weights and BN state "
                f"bit-equal to the uninterrupted run (cuDNN deterministic)")
            del ref, retried
            torch.cuda.empty_cache()
            x = np.random.RandomState(0).randn(
                TRAIN_BATCH, 3, TRAIN_IMG, TRAIN_IMG).astype(np.float32)
            y = (np.random.RandomState(1).randint(0, TRAIN_CLASSES,
                                                  TRAIN_BATCH)
                 + 1).astype(np.float32)
            l_loss, d_loss, rel, _ = _distri_vs_local(False, x, y)
            f_loss, fd_loss, _, launches = _distri_vs_local(True, x, y)
        finally:
            torch.backends.cudnn.deterministic, \
                torch.backends.cudnn.benchmark = det
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(d_loss, l_loss))
        bf16_gap = max(abs(a - b) for a, b in zip(fd_loss, f_loss))
        want = (36 * DISTRI_STEPS, 16 * DISTRI_STEPS)
        got = (launches["conv_bn_1x1"], launches["conv_bn_kxk"])
        say(f"phase 15 (c) DistriOptimizer vs LocalOptimizer, {DISTRI_STEPS} "
            f"steps, cuDNN deterministic: f32 (f32 wire) losses {['%.6f' % v for v in d_loss]} vs "
            f"{['%.6f' % v for v in l_loss]}, worst relative gap "
            f"{loss_rel:.3e} (limit {DISTRI_F32_TOL:g}), params relative L2 "
            f"{rel:.3e} (limit {DISTRI_F32_TOL:g}); fused bf16 (bf16 wire) "
            f"losses {['%.5f' % v for v in fd_loss]} vs "
            f"{['%.5f' % v for v in f_loss]}, worst gap {bf16_gap:.3e} "
            f"(limit {LOSS_TOL:g}); conv_bn launches {got[0]} 1x1, {got[1]} "
            f"kxk (want {want[0]}, {want[1]})")
        if len(d_loss) != DISTRI_STEPS or not loss_rel <= DISTRI_F32_TOL \
                or not rel <= DISTRI_F32_TOL:
            raise AssertionError("f32 DistriOptimizer off LocalOptimizer")
        if len(fd_loss) != DISTRI_STEPS or not bf16_gap <= LOSS_TOL:
            raise AssertionError("bf16 DistriOptimizer off LocalOptimizer")
        if got != want:
            raise AssertionError(f"fused DistriOptimizer launched conv_bn "
                                 f"{got}, want {want}")
        # why (b) and (c) run deterministic: the f32 comparison again on
        # cuDNN's default algorithms, beside LocalOptimizer against a
        # second LocalOptimizer run on the same inputs (lines, no limit)
        from bigdl_tpu_torch.optim import DistriOptimizer, LocalOptimizer

        n_local = _trainer_arm(LocalOptimizer, False, x, y)
        n_local2 = _trainer_arm(LocalOptimizer, False, x, y)
        n_distri = _trainer_arm(DistriOptimizer, False, x, y)
        gd, gl = _gaps(n_distri, n_local), _gaps(n_local2, n_local)
        say(f"phase 15 (c) the f32 comparison on cuDNN's default "
            f"algorithms (no limit): Distri vs Local worst relative loss "
            f"gap {gd[0]:.3e}, params relative L2 {gd[1]:.3e}; Local vs a "
            f"second Local run {gl[0]:.3e}, {gl[1]:.3e}")
        del n_local, n_local2, n_distri

        rs = np.random.RandomState(4)
        ax = rs.randn(AB_BATCHES * IMG_BATCH, 3, IMG_SIZE,
                      IMG_SIZE).astype(np.float32)
        ay = (rs.randint(0, IMG_CLASSES, ax.shape[0]) + 1).astype(np.float32)
        times = _copy_ab(ax, ay)
        say(f"phase 15 (d) input copy A/B, ResNet-50 f32 DistriOptimizer, "
            f"{AB_BATCHES} steps a run, median step ms: pinned "
            f"{['%.3f' % v for v in times['pinned']]}, pageable "
            f"{['%.3f' % v for v in times['pageable']]} (order pinned, "
            f"pageable, pageable, pinned) [{smi}]")
    finally:
        Engine.reset()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    say(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")


# ---- phase 16: Inception-v1/v2 and VGG-16 through the Caffe files ----------
_CLI_RUNNER = r"""
import json, runpy, sys, time
from bigdl_tpu_torch.optim import distri_optimizer as D, optimizer as O
rec = {"loss": {}, "at": {}, "val": []}


class Rec:
    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            rec["loss"][step] = value
            rec["at"][step] = time.perf_counter()
        elif tag != "Throughput":
            rec["val"].append([tag, step, value])


def recording(base):
    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.set_train_summary(Rec()).set_val_summary(Rec())
    return Recording


D.DistriOptimizer = recording(D.DistriOptimizer)
O.LocalOptimizer = recording(O.LocalOptimizer)
out = sys.argv.pop(1)
sys.argv[0] = "bigdl_tpu_torch.models.inception"
try:
    runpy.run_module("bigdl_tpu_torch.models.inception", run_name="__main__",
                     alter_sys=True)
finally:
    with open(out, "w") as f:
        json.dump(rec, f)
"""


def _inception_cli(args, out: str):
    """``python -m bigdl_tpu_torch.models.inception ARGS`` in a child
    process whose trainers record each loss (and when it was read) and
    each validation into ``out``.  Returns (record, stderr, seconds)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", _CLI_RUNNER, out] + args
                         + ["--device", DEV], cwd=root, capture_output=True,
                         text=True, timeout=600)
    secs = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"inception CLI {args} exited "
                             f"{res.returncode}: {res.stderr[-3000:]}")
    with open(out) as f:
        rec = json.load(f)
    rec["loss"] = {int(k): v for k, v in rec["loss"].items()}
    rec["at"] = {int(k): v for k, v in rec["at"].items()}
    return rec, res.stderr, secs


@contextlib.contextmanager
def _tf32():
    """TF32 matmuls and convs, for the lower-precision control of the
    CPU comparisons; full f32 again after."""
    b = torch.backends
    was = (b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32)
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        b.cuda.matmul.allow_tf32, b.cudnn.allow_tf32 = was


def _caffe_models():
    """(name, the model with its LogSoftMax dropped, optimizer factory):
    Caffe's idiom is logits into SoftmaxWithLoss.  Random weights from
    seed 0."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.inception import (build_inception_v1,
                                                  inception_recipe_optim)
    from bigdl_tpu_torch.models.vgg import build_vgg16
    from bigdl_tpu_torch.optim import SGD

    steps = 1 + CAFFE_STEPS
    for name, build, optim in (
            ("Inception-v1", lambda: build_inception_v1(
                1000, has_dropout=False, device=DEV),
             lambda bs: inception_recipe_optim(bs, 1, steps)),
            ("VGG-16", lambda: build_vgg16(1000, device=DEV),
             lambda bs: SGD(learningrate=0.01, momentum=0.9))):
        RandomGenerator.RNG.set_seed(0)
        model = build()
        model.modules = model.modules[:-1]
        yield name, model, optim


def _round_trip(name, model, tmp):
    """(b): ``to_graph`` -> ``CaffePersister`` -> ``CaffeLoader`` on the
    card, the loaded forward against the exported graph's and against
    the CPU's.  Returns (loaded graph, prototxt, caffemodel)."""
    from bigdl_tpu_torch.utils.caffe import CaffeLoader, CaffePersister

    graph = model.to_graph().evaluate()
    proto = os.path.join(tmp, name + ".prototxt")
    cm = os.path.join(tmp, name + ".caffemodel")
    t0 = time.perf_counter()
    CaffePersister.save(graph, proto, cm,
                        input_shape=(3, CAFFE_IMG, CAFFE_IMG))
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = CaffeLoader(proto, cm, device=DEV).load().evaluate()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = torch.randn(CAFFE_FWD_BATCH, 3, CAFFE_IMG, CAFFE_IMG,
                    generator=torch.Generator().manual_seed(5)).to(DEV)
    with torch.no_grad():
        ref, y = graph(x), loaded(x)
        card = float((y - ref).abs().max() / ref.abs().max())
        cpu_graph = CaffeLoader(proto, cm, device="cpu").load().evaluate()
        xc = x[:CAFFE_CPU_BATCH].cpu()
        yc = cpu_graph(xc)
        cpu = float((y[:CAFFE_CPU_BATCH].cpu() - yc).abs().max()
                    / yc.abs().max())
        with _tf32():
            y_tf32 = loaded(x[:CAFFE_CPU_BATCH]).cpu()
        tf32 = float((y_tf32 - yc).abs().max() / yc.abs().max())
    say(f"phase 16 (b) {name}: to_graph {len(graph.topo_order())} nodes; "
        f"CaffePersister {os.path.getsize(proto)} + {os.path.getsize(cm)} "
        f"bytes in {save_s:.2f} s; CaffeLoader on the card {load_s:.2f} s "
        f"({len(loaded.topo_order())} nodes); forward at batch "
        f"{CAFFE_FWD_BATCH} against the exported graph's, relative "
        f"{card:.3e} (limit {CAFFE_CARD_TOL:g}); against the CPU's at batch "
        f"{CAFFE_CPU_BATCH} {cpu:.3e} (limit {CAFFE_CPU_TOL:g}); the same "
        f"card forward with TF32 on (the control) {tf32:.3e}, "
        f"{'over' if tf32 > CAFFE_CPU_TOL else 'within'} the limit")
    if not card <= CAFFE_CARD_TOL or not cpu <= CAFFE_CPU_TOL:
        raise AssertionError(f"{name}: loaded graph off the exported one")
    if tuple(y.shape) != (CAFFE_FWD_BATCH, 1000) or \
            not bool(torch.isfinite(y).all()):
        raise AssertionError(f"{name}: loaded forward {tuple(y.shape)}")
    del cpu_graph, graph
    return loaded, proto, cm


def _caffe_train(model, optim, x, y):
    """(c): one warm-up step, then ``CAFFE_STEPS`` timed steps of
    ``model`` by ``DistriOptimizer`` at world 1, f32 on the f32 wire,
    ``CrossEntropyCriterion``.  Returns (optimizer, losses, step ms,
    peak bytes)."""
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import DistriOptimizer, Trigger

    bs = CAFFE_BATCH
    opt = DistriOptimizer(model, ArrayDataSet(x, y, bs, shuffle=False),
                          CrossEntropyCriterion(), bs, wire_dtype="float32",
                          device=DEV)
    opt.set_optim_method(optim(bs))
    losses = _Losses()
    opt.set_train_summary(losses)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opt.set_end_when(Trigger.max_iteration(1)).optimize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.set_end_when(Trigger.max_iteration(1 + CAFFE_STEPS)).optimize()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / CAFFE_STEPS * 1e3
    loss = [losses.loss[n] for n in sorted(losses.loss)]
    if len(loss) != 1 + CAFFE_STEPS or not all(np.isfinite(loss)):
        raise AssertionError(f"missing or non-finite losses {loss}")
    return opt, loss, step_ms, torch.cuda.max_memory_allocated()


def _inception_cpu_gap(proto, cm):
    """(c): the loaded Inception-v1's first losses on the card
    (``DistriOptimizer``, f32 wire) against ``LocalOptimizer`` on the
    card machine's CPU, from the same files and batches; dropout is off
    in this model and cuDNN runs deterministic.  The card's run is made
    again with TF32 on, the control.  Returns (card losses, CPU losses,
    worst relative gap, the control's)."""
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.models.inception import inception_recipe_optim
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import DistriOptimizer, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.caffe import CaffeLoader

    bs, n = INC_CPU_BATCH, INC_CPU_STEPS
    rs = np.random.RandomState(7)
    x = rs.randn(bs * n, 3, CAFFE_IMG, CAFFE_IMG).astype(np.float32)
    y = (rs.randint(0, 1000, bs * n) + 1).astype(np.float32)
    def run(cls, dev, **kw):
        model = CaffeLoader(proto, cm, device=dev).load()
        opt = cls(model, ArrayDataSet(x, y, bs, shuffle=False),
                  CrossEntropyCriterion(), bs, device=dev, **kw)
        opt.set_optim_method(inception_recipe_optim(bs, 1, n))
        losses = _Losses()
        opt.set_train_summary(losses).set_end_when(Trigger.max_iteration(n))
        opt.optimize()
        return [losses.loss[k] for k in sorted(losses.loss)]

    card = run(DistriOptimizer, DEV, wire_dtype="float32")
    cpu = run(LocalOptimizer, "cpu")
    with _tf32():
        tf32 = run(DistriOptimizer, DEV, wire_dtype="float32")
    if not len(card) == len(cpu) == len(tf32) == n:
        raise AssertionError(f"CPU comparison: losses {card} / {cpu}")

    def gap(run):
        return max(abs(a - b) / abs(b) for a, b in zip(run, cpu))

    return card, cpu, gap(card), gap(tf32)


def _check_graph_checkpoint(ck, proto, cm, snapshot) -> int:
    """(d): the trainer's checkpoint of the loaded Inception-v1
    graph, reloaded on the CPU through ``load_latest_checkpoint`` into
    a graph loaded from the same files, and as the graph its spec
    rebuilds, bit-equal to the weights it was written from.  Returns
    the model file's bytes."""
    from bigdl_tpu_torch.utils import serializer as S
    from bigdl_tpu_torch.utils import tree as T
    from bigdl_tpu_torch.utils.caffe import CaffeLoader

    (prefix,) = S.checkpoint_prefixes(ck)
    path = os.path.join(ck, prefix)
    ok, reason = S.verify_checkpoint(path)
    if not ok:
        raise AssertionError(f"graph checkpoint: {reason}")
    cpu = CaffeLoader(proto, cm, device="cpu").load()
    S.load_latest_checkpoint(ck, cpu)
    rebuilt = S.load_module(path + ".model")
    for got in (T.leaves(cpu.params()), T.leaves(rebuilt.params())):
        if len(got) != len(snapshot) or not all(
                torch.equal(a, b) for a, b in zip(got, snapshot)):
            raise AssertionError("graph checkpoint differs from the "
                                 "trained graph")
    return os.path.getsize(path + ".model.npz")


def phase_caffe(smi: str) -> None:
    """Phase 16: BASELINE config 3.  (a) the inception CLI from an image
    folder and on the synthetic task; (b) Inception-v1 and VGG-16 at full
    width through ``to_graph`` -> ``CaffePersister`` -> ``CaffeLoader``
    on the card; (c) ``DistriOptimizer`` trains both loaded graphs, with
    timings, peak memory, a profile, the Sequential/Graph A/B and the
    CPU comparison; (d) the loaded graph's checkpoint."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.utils import serializer as S
    from bigdl_tpu_torch.utils import tree as T

    t_phase = time.perf_counter()
    kernels_before = _model_launches()
    tmp = tempfile.mkdtemp(prefix="phase16_")
    try:
        # (a) the entry point, in a child process
        root = os.path.join(tmp, "data")
        _write_image_folder(root)
        ck = os.path.join(tmp, "cli_ck")
        rec, log, secs = _inception_cli(
            ["-f", root, "--version", "v1", "-b", str(INC_CLI_BATCH), "-e",
             str(INC_CLI_EPOCHS), "--checkpoint", ck],
            os.path.join(tmp, "cli_v1.json"))
        per_epoch = IMG_CLASSES * IMG_TRAIN // INC_CLI_BATCH
        loss = [rec["loss"][n] for n in sorted(rec["loss"])]
        vals = {t: v for t, _, v in rec["val"]}
        printed = [t for t in ("Top1Accuracy", "Top5Accuracy")
                   if f"validation {t}:" in log]
        if len(loss) != INC_CLI_EPOCHS * per_epoch or \
                not all(np.isfinite(loss)):
            raise AssertionError(f"inception CLI: losses {loss}")
        if len(printed) != 2 or not all(
                np.isfinite(vals.get(t, np.nan)) for t in printed):
            raise AssertionError(f"inception CLI: validation {rec['val']}")
        prefixes = S.checkpoint_prefixes(ck)
        if len(prefixes) != INC_CLI_EPOCHS or not all(
                S.verify_checkpoint(os.path.join(ck, p))[0]
                for p in prefixes):
            raise AssertionError(f"inception CLI: checkpoints {prefixes}")
        step_ms = steady_step_ms(rec["at"], per_epoch)
        say(f"phase 16 (a) python -m bigdl_tpu_torch.models.inception -f "
            f"DIR --version v1 -b {INC_CLI_BATCH} -e {INC_CLI_EPOCHS} "
            f"--checkpoint CK: {len(loss)} losses "
            f"{['%.4f' % v for v in loss]}; Top1 "
            f"{vals['Top1Accuracy']:.4f}, Top5 {vals['Top5Accuracy']:.4f} "
            f"logged; 1 checkpoint verified; step {step_ms:.3f} ms "
            f"(median wall gap), {INC_CLI_BATCH / step_ms * 1e3:.1f} "
            f"images/s; {secs:.1f} s in all [{smi}]")
        rec, _, secs = _inception_cli(
            ["--version", "v2", "-n", str(INC_V2_N), "-b",
             str(INC_CLI_BATCH), "-e", "1"], os.path.join(tmp, "cli_v2.json"))
        loss = [rec["loss"][n] for n in sorted(rec["loss"])]
        if len(loss) != INC_V2_N // INC_CLI_BATCH or \
                not all(np.isfinite(loss)):
            raise AssertionError(f"inception CLI v2: losses {loss}")
        say(f"phase 16 (a) --version v2 -n {INC_V2_N} -b {INC_CLI_BATCH} -e "
            f"1 (synthetic): losses {['%.4f' % v for v in loss]}; "
            f"{secs:.1f} s in all")

        # (b) the Caffe round trip, (c) training the loaded graphs
        rs = np.random.RandomState(6)
        n = (1 + CAFFE_STEPS) * CAFFE_BATCH
        x = rs.randn(n, 3, CAFFE_IMG, CAFFE_IMG).astype(np.float32)
        y = (rs.randint(0, 1000, n) + 1).astype(np.float32)
        for name, seq, optim in _caffe_models():
            loaded, proto, cm = _round_trip(name, seq, tmp)
            opt, loss, step_ms, peak = _caffe_train(loaded, optim, x, y)
            say(f"phase 16 (c) {name} loaded graph, DistriOptimizer world "
                f"{opt.n_shards} on {Engine._state.backend}, f32 (f32 wire), "
                f"batch {CAFFE_BATCH} at {CAFFE_IMG}x{CAFFE_IMG}: losses "
                f"{['%.4f' % v for v in loss]}; step {step_ms:.3f} ms over "
                f"steps 2-{1 + CAFFE_STEPS} "
                f"({CAFFE_BATCH / step_ms * 1e3:.1f} images/s); peak "
                f"{peak / 2**30:.2f} GiB allocated [{smi}]")
            phase_train_profile(opt, 16, f"loaded {name} step")
            if name == "Inception-v1":
                # (d) one more step, checkpointed by the trainer
                graph_ck = os.path.join(tmp, "graph_ck")
                opt.set_checkpoint(graph_ck, Trigger.several_iteration(1))
                opt.set_end_when(Trigger.max_iteration(opt.state["neval"]))
                opt.optimize()
                snapshot = [p.detach().cpu().clone()
                            for p in T.leaves(loaded.params())]
            del opt
            if name == "Inception-v1":
                # the Graph scheduler's host cost: the Sequential against
                # its loaded Graph, turn about
                ab = {"Sequential": [], "Graph": [step_ms]}
                for arm in ("Sequential", "Graph", "Sequential"):
                    _, _, ms, _ = _caffe_train(
                        seq if arm == "Sequential" else loaded, optim, x, y)
                    ab[arm].append(ms)
                say(f"phase 16 (c) Inception-v1 step ms, Sequential "
                    f"{['%.3f' % v for v in ab['Sequential']]} against its "
                    f"loaded Graph {['%.3f' % v for v in ab['Graph']]} "
                    f"(order Graph, Sequential, Graph, Sequential) [{smi}]")
                size = _check_graph_checkpoint(graph_ck, proto, cm,
                                               snapshot)
                say(f"phase 16 (d) the loaded graph's checkpoint "
                    f"({size} bytes) verified, reloaded on the CPU by "
                    f"load_latest_checkpoint and by its spec: bit-equal")
                det = (torch.backends.cudnn.deterministic,
                       torch.backends.cudnn.benchmark)
                torch.backends.cudnn.deterministic = True
                torch.backends.cudnn.benchmark = False
                try:
                    card, cpu, gap, tf32 = _inception_cpu_gap(proto, cm)
                finally:
                    torch.backends.cudnn.deterministic, \
                        torch.backends.cudnn.benchmark = det
                say(f"phase 16 (c) Inception-v1 loaded graph, batch "
                    f"{INC_CPU_BATCH}, cuDNN deterministic: card losses "
                    f"{['%.6f' % v for v in card]}, CPU "
                    f"{['%.6f' % v for v in cpu]}, worst relative gap "
                    f"{gap:.3e} (limit {INC_CPU_TOL:g}); the card's run "
                    f"with TF32 on (the control) {tf32:.3e}, "
                    f"{'over' if tf32 > INC_CPU_TOL else 'within'} the "
                    "limit")
                if not gap <= INC_CPU_TOL:
                    raise AssertionError("Inception-v1 card losses off the "
                                         "CPU's")
            del loaded, seq
            torch.cuda.empty_cache()
        if _model_launches() != kernels_before:
            raise AssertionError("phase 16 launched a kernel of csrc/")
    finally:
        Engine.reset()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    say(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")


# ---- phase 17: the serving tier over HTTP, int8, drain, swap, config 5 ----
def _http(url, payload=None, headers=None, timeout=600.0):
    """One HTTP call (POST with ``payload``, else GET): (status, headers,
    JSON body, client seconds)."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(
        url, data=data, headers={"Content-Type": "application/json",
                                 **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        out = e.code, dict(e.headers), json.loads(e.read())
    return out + (time.perf_counter() - t0,)


def _in_threads(fn, n: int) -> list:
    """``fn(i)`` for i < n, each on its own thread, all started
    together; the results in order."""
    import threading

    out = [None] * n

    def run(i):
        out[i] = fn(i)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads) or any(o is None for o in out):
        raise AssertionError("an HTTP client did not finish")
    return out


def _pct(vals, q) -> float:
    return float(np.percentile(vals, q))


def _generate_burst(srv, prompts, ids=None, headers=None) -> list:
    return _in_threads(lambda i: _http(
        srv.url("/v1/generate"),
        {"prompt": [int(t) for t in prompts[i]],
         "max_new_tokens": SERVE_NEW_TOKENS,
         **({"request_id": ids[i]} if ids else {})},
        headers=headers(i) if headers else None), len(prompts))


def _check_served(model, prompts, answers, what: str) -> list:
    """Every answer 200 with its tokens, each within 1e-3 of the top
    logit of ``model``'s full forward; returns the token lists."""
    bad = [a[:1] + (a[2].get("error"),) for a in answers
           if a[0] != 200 or len(a[2]["tokens"]) != SERVE_NEW_TOKENS]
    if bad:
        raise AssertionError(f"{what}: failed or short answers {bad}")
    toks = [a[2]["tokens"] for a in answers]
    gap = _top_logit_gap(model, prompts, toks)
    say(f"phase 17 {what}: worst (top logit - served token's logit) "
        f"{gap:.3e} (limit 1e-3)")
    if gap > 1e-3:
        raise AssertionError(f"{what}: served token off the top logit by "
                             f"{gap}")
    return toks


def _serve_http(srv, model, resnet, images, direct_ttft: float):
    """(a): 12 concurrent /v1/generate clients, then 8 concurrent
    single-image /v1/classify clients, through one ServingServer."""
    from bigdl_tpu_torch.ops import _cuda

    prompts = _serving_prompts()
    _http(srv.url("/v1/generate"), {"prompt": [1, 2, 3],
                                    "max_new_tokens": 2})      # warm
    _http(srv.url("/v1/classify"), {"inputs": images[:1].tolist()})
    torch.cuda.synchronize()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    answers = _generate_burst(srv, prompts)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    toks = _check_served(model, prompts, answers, "(a) /v1/generate")
    ttft = [a[2]["ttft_s"] for a in answers]
    e2e = [a[3] for a in answers]
    http = [a[3] - a[2]["e2e_s"] for a in answers]
    say(f"phase 17 (a) 12 clients x {SERVE_NEW_TOKENS} tokens over HTTP "
        f"in {wall:.3f} s, {12 * SERVE_NEW_TOKENS / wall:.1f} tokens/s; "
        f"TTFT (engine, from the answers) p50 {_pct(ttft, 50) * 1e3:.2f} / "
        f"p99 {_pct(ttft, 99) * 1e3:.2f} ms against phase 4's direct p50 "
        f"{direct_ttft * 1e3:.2f} ms; client e2e p50 "
        f"{_pct(e2e, 50) * 1e3:.2f} / p99 {_pct(e2e, 99) * 1e3:.2f} ms, of "
        f"it HTTP (client wall - engine e2e) p50 "
        f"{_pct(http, 50) * 1e3:.2f} ms; launches {launches}")
    if launches["flash_fwd"] <= 0 or launches["paged_decode"] <= 0:
        raise AssertionError(f"the HTTP path launched {launches}")

    with torch.no_grad():
        ref = resnet(torch.from_numpy(images).to(DEV)).float().cpu().numpy()
    t0 = time.perf_counter()
    cls = _in_threads(lambda i: _http(
        srv.url("/v1/classify"), {"inputs": images[i:i + 1].tolist()}),
        len(images))
    cls_wall = time.perf_counter() - t0
    if any(a[0] != 200 for a in cls):
        raise AssertionError(f"classify failed: {[a[2] for a in cls]}")
    out = np.concatenate([np.asarray(a[2]["outputs"], np.float32)
                          for a in cls])
    err = float(np.abs(out - ref).max() / np.abs(ref).max())
    same = int(np.sum(np.argmax(out, 1) == np.argmax(ref, 1)))
    top2 = np.sort(ref, axis=1)[:, -2:]
    say(f"phase 17 (a) /v1/classify: {len(images)} single-image clients "
        f"in {cls_wall:.3f} s, {len(images) / cls_wall:.1f} images/s over "
        f"HTTP (JSON of 150528 floats each); outputs against resnet(x) at "
        f"batch {len(images)}: {err:.3e} of max |y| (limit "
        f"{SERVE_CLS_TOL:g}), argmax equal {same}/{len(images)}, smallest "
        f"top-2 gap {float((top2[:, 1] - top2[:, 0]).min()):.3e}")
    if not err <= SERVE_CLS_TOL or same != len(images):
        raise AssertionError("classify outputs off resnet(x)")

    st = _http(srv.url("/stats"))[2]
    health = _http(srv.url("/healthz"))[2]
    keys = {"draining", "weight_version", "manifest_sha", "weight_swaps",
            "int8", "requests", "tokens", "ttft_p50_s"}
    if (not keys <= set(st["lm"]) or st["lm"]["requests"] < 13
            or st["classifier"]["requests"] < len(images) + 1
            or health != {"status": "ok", "weight_version": "v0",
                          "manifest_sha": None}):
        raise AssertionError(f"/stats {st} or /healthz {health}")
    say(f"phase 17 (a) /healthz {health}; /stats lm requests "
        f"{st['lm']['requests']}, decode step "
        f"{st['lm']['decode_ms_mean']:.3f} ms mean, classifier "
        f"{st['classifier']}")
    return toks, ref


def _int8_mm_checks() -> None:
    """(b) the int8 GEMM on the card against its exact plain version at
    the decode shapes and three ResNet-50 conv shapes (batch 8)."""
    from bigdl_tpu_torch.ops.quantized_matmul import int8_mm, int8_mm_plain

    gen = torch.Generator(device=DEV)
    gen.manual_seed(5)
    for name, (m, k, n) in INT8_MM_SHAPES:
        a = torch.randint(-127, 128, (m, k), dtype=torch.int8,
                          device=DEV, generator=gen)
        w = torch.randint(-127, 128, (n, k), dtype=torch.int8,
                          device=DEV, generator=gen)
        got, want = int8_mm(a, w), int8_mm_plain(a, w)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"int8_mm {name} ({m}, {k}, {n}): "
                                 "accumulators differ")
        xf, wf = a.float(), w.float()
        try:                              # the library's own shape rules
            torch._int_mm(a, w.t())
            bare = "takes it unpadded"
        except RuntimeError as e:
            bare = f"refuses it unpadded ({str(e).splitlines()[0][:80]})"
        say(f"phase 17 (b) int8_mm {name} M={m} K={k} N={n}: torch._int_mm "
            f"{bare}")
        say(f"phase 17 (b) int8_mm {name} M={m} K={k} N={n}: int32 "
            f"accumulators equal; {time_ms(lambda: int8_mm(a, w)):.4f} ms "
            f"(f32 matmul {time_ms(lambda: xf @ wf.t()):.4f}, f64 plain "
            f"{time_ms(lambda: int8_mm_plain(a, w), reps=5):.4f})")


def _int8_serving(model, float_toks, float_stats, resnet, images, ref):
    """(b) the int8 LMEngine and ClassifierEngine against the float
    ones."""
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.serving import ClassifierEngine

    prompts = _serving_prompts()
    eng = _lm_engine(model, int8=True)
    f32 = _lm_engine(model)
    try:
        _cuda.reset_launches()
        reqs = [eng.submit(p, SERVE_NEW_TOKENS) for p in prompts]
        eng.run_until_idle(600)
        torch.cuda.synchronize()
        launches = dict(_cuda.launches)
        st = eng.stats()
        ratio = eng._weight_bytes / f32._weight_bytes
        toks = [r.tokens for r in reqs]
        if any(r.error or len(t) != SERVE_NEW_TOKENS or
               not all(0 <= v < 8192 for v in t)
               for r, t in zip(reqs, toks)) or launches["paged_decode"] <= 0:
            raise AssertionError(f"int8 engine: {[r.error for r in reqs]}, "
                                 f"launches {launches}")
        agree = np.mean([a == b for ta, tb in zip(toks, float_toks)
                         for a, b in zip(ta, tb)])
        say(f"phase 17 (b) int8 LMEngine: 12 x {SERVE_NEW_TOKENS} tokens, "
            f"all in the vocab; tokens equal to the float engine's "
            f"{agree:.3f}, requests equal "
            f"{sum(a == b for a, b in zip(toks, float_toks))}/12; decode "
            f"step {st['decode_ms_mean']:.3f} ms mean (float "
            f"{float_stats['decode_ms_mean']:.3f}); weight bytes a step "
            f"{eng._weight_bytes:.0f} against {f32._weight_bytes:.0f} "
            f"({ratio:.3f}), {eng._weight_bytes / 8:.0f} a token at a full "
            f"batch; launches {launches}")
    finally:
        eng.close()
        f32.close()

    for int8 in (False, True):
        clf = ClassifierEngine(resnet, max_batch=len(images), int8=int8,
                               batch_window_s=0.0, device=DEV)
        try:
            reqs = [clf.submit(x) for x in images]
            clf.pump()                                  # warm
            torch.cuda.synchronize()
            reqs = [clf.submit(x) for x in images]
            t0 = time.perf_counter()
            while not all(r.done for r in reqs):
                clf.pump()
            wall = time.perf_counter() - t0
        finally:
            clf.close()
        if any(r.error for r in reqs):
            raise AssertionError(f"classifier int8={int8}: "
                                 f"{[r.error for r in reqs]}")
        out = np.stack([r.result for r in reqs])
        if not np.isfinite(out).all():
            raise AssertionError(f"classifier int8={int8}: non-finite")
        agree = int(np.sum(np.argmax(out, 1) == np.argmax(ref, 1)))
        say(f"phase 17 (b) ClassifierEngine int8={int8} on ResNet-50, "
            f"batch {len(images)}: {len(images) / wall:.1f} images/s "
            f"({wall * 1e3:.2f} ms, direct); top-1 equal to float "
            f"{agree}/{len(images)}; max |y - float| "
            f"{float(np.abs(out - ref).max()):.3e}")


def _drain_over_http(srv, lm, model, float_toks):
    """(c): /admin/drain with deadline 0 while the 12 requests decode;
    each handoff replayed once on a second engine with the same
    weights.  Returns that engine."""
    from bigdl_tpu_torch.obs.reqtrace import TRACE_HEADER
    from bigdl_tpu_torch.serving import HandoffLedger, HandoffRecord

    prompts = _serving_prompts()
    ids = [f"r{i}" for i in range(len(prompts))]
    done0, start = len(lm.completed), lm.stats()["tokens"]
    drained = {}

    def taken_and_decoded():
        """(requests the engine holds or has finished since the burst
        began, tokens since then), read between two steps."""
        with lm.locked():
            return (lm.queue.depth() + lm.active_count() + len(lm._stash)
                    + len(lm.completed) - done0,
                    lm.stats()["tokens"] - start)

    def drain_when_decoding():
        # every request in the engine (none refused at the door) and
        # some tokens decoded
        deadline = time.monotonic() + 300
        while True:
            taken, decoded = taken_and_decoded()
            if taken == len(prompts) and decoded >= DRAIN_AFTER_TOKENS:
                break
            if time.monotonic() > deadline:
                raise AssertionError("the drain's requests never decoded")
            time.sleep(0.002)
        drained["answer"] = _http(srv.url("/admin/drain"),
                                  {"deadline_s": 0})

    import threading

    trigger = threading.Thread(target=drain_when_decoding, daemon=True)
    trigger.start()
    answers = _generate_burst(srv, prompts, ids, headers=lambda i: {
        TRACE_HEADER: f"trace{i}::"})
    trigger.join(timeout=300)
    status, _, body, _ = drained["answer"]
    if status != 200 or not body["draining"]:
        raise AssertionError(f"/admin/drain answered {status} {body}")
    records = {r["request_id"]: HandoffRecord.from_dict(r)
               for r in body["handoffs"]}
    ledger = HandoffLedger()
    replay = _lm_engine(_flagship(0))
    full, n_handoff = [], 0
    for i, (code, headers, ans, _) in enumerate(answers):
        if code == 200 and len(ans["tokens"]) == SERVE_NEW_TOKENS:
            if not ledger.deliver(ids[i]):
                raise AssertionError(f"{ids[i]} delivered twice")
            full.append(ans["tokens"])
            continue
        if code != 503 or "handoff" not in ans:
            raise AssertionError(f"{ids[i]}: answer {code} {ans}")
        rec = HandoffRecord.from_dict(ans["handoff"])
        if ("Retry-After" not in headers or rec != records.get(ids[i])
                or rec.trace != f"trace{i}::"
                or len(rec.tokens_done) + rec.max_new_tokens
                != SERVE_NEW_TOKENS):
            raise AssertionError(f"{ids[i]}: answer {code} {ans}")
        if not ledger.claim(rec.request_id) or ledger.claim(rec.request_id):
            raise AssertionError(f"{ids[i]} claimed twice")
        r = replay.submit(rec.prompt, rec.max_new_tokens,
                          temperature=rec.temperature)
        replay.run_until_idle(600)
        if r.error or not ledger.deliver(rec.request_id):
            raise AssertionError(f"{ids[i]} replay failed: {r.error}")
        full.append(rec.tokens_done + r.tokens)
        n_handoff += 1
    st = ledger.stats()
    say(f"phase 17 (c) drain after {DRAIN_AFTER_TOKENS} tokens: "
        f"{len(prompts) - n_handoff} answered whole, {n_handoff} 503 + "
        f"Retry-After with a handoff (tokens done "
        f"{[len(r.tokens_done) for r in records.values()]}), replayed on a "
        f"second engine: ledger {st}; requests equal to the uninterrupted "
        f"run's {sum(a == b for a, b in zip(full, float_toks))}/12")
    if n_handoff == 0 or st["delivered"] != len(prompts) \
            or st["duplicates"]:
        raise AssertionError(f"drain: {n_handoff} handoffs, ledger {st}")
    _check_served(model, prompts, [(200, {}, {"tokens": t}, 0.0)
                                   for t in full], "(c) drained + replayed")
    return replay


def _swap_over_http(eng):
    """(d): swap_weights to seed 1's weights while four requests
    decode; the eight admitted after it meet the gate on the new
    weights."""
    from bigdl_tpu_torch.serving import ServingServer

    prompts = _serving_prompts()
    new_model = _flagship(1)
    tree = _host_tree(new_model.params())
    srv = ServingServer(lm=eng.start(), port=0)
    try:
        first = {}
        start = eng.stats()["tokens"]
        import threading

        t = threading.Thread(target=lambda: first.update(
            a=_generate_burst(srv, prompts[:4])), daemon=True)
        t.start()
        while eng.stats()["tokens"] - start < 8 and t.is_alive():
            time.sleep(0.001)
        t0 = time.perf_counter()
        eng.swap_weights(tree, version="v1", manifest_sha="seed1")
        swap_s = time.perf_counter() - t0
        after = _generate_burst(srv, prompts[4:])
        t.join(timeout=600)
        health = _http(srv.url("/healthz"))[2]
    finally:
        srv.close()
        eng.close()
    inflight = first.get("a") or []
    if len(inflight) != 4 or any(a[0] != 200 or len(a[2]["tokens"])
                                 != SERVE_NEW_TOKENS for a in inflight):
        raise AssertionError(f"requests across the swap: {inflight}")
    _check_served(new_model, prompts[4:], after,
                  "(d) admitted after swap_weights, new weights")
    say(f"phase 17 (d) swap_weights (numpy tree, host to device on the "
        f"caller's thread) {swap_s * 1e3:.1f} ms; 4 requests across the "
        f"swap answered whole; /healthz {health}")
    if health != {"status": "ok", "weight_version": "v1",
                  "manifest_sha": "seed1"}:
        raise AssertionError(f"/healthz after the swap: {health}")


def _host_tree(params) -> dict:
    """A ``params()`` tree as numpy arrays on the host, as a checkpoint
    gives it."""
    if isinstance(params, dict):
        return {k: _host_tree(v) for k, v in params.items()}
    return params.detach().cpu().numpy()


def _backpressure(model) -> None:
    """(e): an engine nobody pumps, queue capacity 1: 503 +
    Retry-After."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs import names
    from bigdl_tpu_torch.serving import ServingServer

    rejects = obs.get_registry().counter(names.SERVE_REJECTS_TOTAL)
    n0 = rejects._solo().value
    eng = _lm_engine(model, queue_capacity=1)
    srv = ServingServer(lm=eng, port=0, request_timeout_s=0.5)
    try:
        eng.submit([1, 2, 3], 4)
        code, headers, body, sec = _http(
            srv.url("/v1/generate"), {"prompt": [4, 5], "max_new_tokens": 3})
    finally:
        srv.close()
        eng.close()
    say(f"phase 17 (e) full queue: {code}, Retry-After "
        f"{headers.get('Retry-After')}, {body} in {sec:.3f} s")
    if code != 503 or headers.get("Retry-After") != "1" \
            or rejects._solo().value != n0 + 1:
        raise AssertionError("a full queue was not shed with 503")


def _config5_run(device, which: str):
    """One DLClassifier fit + transform over a dict DataFrame: the
    bench's MLP, or LeNet-5 on flat synthetic MNIST rows.  Returns
    (training accuracy, training NLL of the fitted model, its params,
    rows/s)."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset.mnist import load_mnist, normalize
    from bigdl_tpu_torch.dlframes import DLClassifier
    from bigdl_tpu_torch.models.lenet import build_lenet5
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, Linear, LogSoftMax,
                                    ReLU, Sequential)
    from bigdl_tpu_torch.optim.evaluator import predict

    RandomGenerator.RNG.set_seed(0)
    if which == "mlp":
        rs = np.random.RandomState(0)
        x = rs.randn(C5_ROWS, C5_FEAT).astype(np.float32)
        w = rs.randn(C5_FEAT, 4)
        y = (np.argmax(x @ w, axis=1) + 1).astype(np.float32)
        model = Sequential().add(Linear(C5_FEAT, 32)).add(ReLU()) \
            .add(Linear(32, 4)).add(LogSoftMax())
        size, batch, lr = [C5_FEAT], C5_BATCH, C5_LR
    else:
        x, y = load_mnist(None, "train", synthetic_n=LENET_N)
        x = normalize(x).reshape(LENET_N, 784).astype(np.float32)
        model = build_lenet5(device=device)
        size, batch, lr = [28, 28], LENET_BATCH, LENET_LR
    df = {"features": [row for row in x], "label": list(y)}
    est = DLClassifier(model, ClassNLLCriterion(), size, device=device) \
        .set_batch_size(batch).set_max_epoch(C5_EPOCHS) \
        .set_learning_rate(lr)
    RandomGenerator.RNG.set_seed(1)
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted = est.fit(df)
    out = fitted.transform(df)
    if device != "cpu":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    acc = float(np.mean(np.asarray(out["prediction"]) == np.asarray(y)))
    logp = predict(fitted.model, x.reshape([-1] + size), 1024, device)
    nll = float(-np.mean(logp[np.arange(len(y)), np.asarray(y, int) - 1]))
    params = {k: v.detach().cpu().numpy()
              for k, v in fitted.model.state_dict().items()}
    return acc, nll, params, len(x) * (C5_EPOCHS + 1) / dt


def _config5() -> None:
    """(f): BASELINE config 5, DLClassifier over a dict DataFrame on the
    card, against the same run on the CPU."""
    for which in ("mlp", "lenet"):
        acc, nll, params, rows_s = _config5_run(DEV, which)
        cacc, cnll, cparams, crows_s = _config5_run("cpu", which)
        gap = max(float(np.abs(params[k] - cparams[k]).max())
                  for k in params)
        say(f"phase 17 (f) config 5 DLClassifier, {which}: training "
            f"accuracy {acc:.4f} (CPU {cacc:.4f}, gate > {C5_ACC_MIN}); "
            f"fitted NLL {nll:.6f} (CPU {cnll:.6f}, relative gap "
            f"{abs(nll - cnll) / abs(cnll):.3e}); weights' max |card - CPU| "
            f"{gap:.3e}; {rows_s:.1f} rows/s through fit + transform on "
            f"the card (CPU {crows_s:.1f})")
        if not acc > C5_ACC_MIN or not np.isfinite(nll):
            raise AssertionError(f"config 5 {which}: accuracy {acc}")


def _optim_cases() -> dict:
    """Phase 18 (a)'s methods: the eight ported ones, and SGD under the
    three new schedules."""
    from bigdl_tpu_torch import optim as O

    return {
        "Adam": lambda: O.Adam(learningrate=1e-3, learningrate_decay=0.1),
        "Adagrad": lambda: O.Adagrad(learningrate=0.01, weightdecay=1e-3),
        "Adadelta": lambda: O.Adadelta(decayrate=0.9, epsilon=1e-6),
        "Adamax": lambda: O.Adamax(learningrate=2e-3),
        "RMSprop": lambda: O.RMSprop(learningrate=1e-2,
                                     learningrate_decay=0.1),
        "Ftrl": lambda: O.Ftrl(learningrate=0.1,
                               l1_regularization_strength=1e-3,
                               l2_regularization_strength=1e-2,
                               l2_shrinkage_regularization_strength=1e-2),
        "LBFGS": lambda: O.LBFGS(learningrate=0.1),
        "LarsSGD": lambda: O.LarsSGD(learningrate=0.5, trust_coefficient=0.02,
                                     momentum=0.9, weightdecay=1e-3),
        "SGD+Step": lambda: O.SGD(learningrate=0.1, momentum=0.9,
                                  learningrate_schedule=O.Step(2, 0.5)),
        "SGD+Exponential": lambda: O.SGD(
            learningrate=0.1, learningrate_schedule=O.Exponential(2, 0.5)),
        "SGD+EpochDecay": lambda: O.SGD(
            learningrate=0.1,
            learningrate_schedule=O.EpochDecay(lambda e: 0.5 * e)),
    }


def _method_steps(make, params0, noise, device):
    """``OPT_STEPS`` steps of a fresh method from ``params0`` on
    ``device``, the gradient 0.5·p + noise; returns (params, the card's
    ms of each step or None)."""
    p = [t.to(device, copy=True) for t in params0]
    nz = [t.to(device) for t in noise]
    m = make()
    state = m.init_state(p)
    times = []
    for _ in range(OPT_STEPS):
        g = [0.5 * a + n for a, n in zip(p, nz)]
        if device == DEV:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        p, state = m.step(g, p, state)
        if device == DEV:
            end.record()
            times.append((start, end))
    if device != DEV:
        return p, None
    torch.cuda.synchronize()
    return p, [s.elapsed_time(e) for s, e in times]


def _ulp(t: torch.Tensor) -> torch.Tensor:
    """One f32 ulp of each |t|."""
    a = t.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def _phase_optim_steps() -> None:
    """(a): each method's steps at the flagship's parameter shapes."""
    from bigdl_tpu_torch.utils import tree as T

    model = _lm("reference", LM_T)
    params0 = [v.detach().cpu().clone() for v in T.leaves(model.params())]
    del model
    torch.cuda.empty_cache()
    gen = torch.Generator().manual_seed(18)
    noise = [0.1 * torch.randn(t.shape, generator=gen) + 0.05
             for t in params0]
    n = sum(t.numel() for t in params0)
    for name, make in _optim_cases().items():
        if name == "LBFGS":
            torch.cuda.reset_peak_memory_stats()
        card, times = _method_steps(make, params0, noise, DEV)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        card = [t.cpu() for t in card]
        t0 = time.perf_counter()
        cpu, _ = _method_steps(make, params0, noise, "cpu")
        cpu_s = time.perf_counter() - t0
        moved = max(float((c - p0).abs().max()) for c, p0 in zip(cpu, params0))
        err = max(float((a - b).abs().max()) for a, b in zip(card, cpu))
        over = max(float(((a - b).abs() - _ulp(b)).max())
                   for a, b in zip(card, cpu))
        rel = max(over, 0.0) / moved if moved > 0 else float("inf")
        say(f"phase 18 (a) {name}: {len(params0)} tensors, {n} f32 values, "
            f"{OPT_STEPS} steps; ms a step on the card "
            f"{['%.3f' % t for t in times]}; max |card - CPU| {err:.3e}, "
            f"beyond an ulp of p {over:.3e}, over largest |dp| {moved:.3e} "
            f"= {rel:.3e} (limit {OPT_REL_TOL:g}); CPU {cpu_s:.1f} s"
            + (f"; peak memory {peak:.2f} GiB" if name == "LBFGS" else ""))
        if not all(torch.isfinite(t).all() for t in card):
            raise AssertionError(f"{name}: non-finite parameters on the card")
        if not rel <= OPT_REL_TOL:
            raise AssertionError(f"{name}: card off the CPU by {rel:.3e} of "
                                 "the update")
        del card, cpu


def _ncf_train(device, x, y, end):
    """NCF at ml-1m's id ranges from the seed-0 weights and the seed-1
    shuffle, trained by ``LocalOptimizer`` with Adam until ``end``:
    (model, losses)."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.ncf import build_ncf
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer

    RandomGenerator.RNG.set_seed(0)
    model = build_ncf(NCF_USERS, NCF_ITEMS, class_num=2, device=device)
    RandomGenerator.RNG.set_seed(1)
    losses = _TimedLosses()
    opt = LocalOptimizer(model, (x, y), ClassNLLCriterion(), NCF_BATCH,
                         device=device)
    opt.set_optim_method(Adam(learningrate=NCF_LR))
    opt.set_end_when(end).set_train_summary(losses)
    opt.optimize()
    return model, losses


def _phase_optim_ncf() -> None:
    """(b): NCF as ``examples/recommendation/ncf_train.py`` runs it."""
    from bigdl_tpu_torch.examples import ncf_train as X
    from bigdl_tpu_torch.optim import Trigger

    t0 = time.perf_counter()
    pos = X.synthetic_interactions(NCF_USERS, NCF_ITEMS)
    x, y = X.training_pairs(pos, NCF_ITEMS)
    data_s = time.perf_counter() - t0
    steps = x.shape[0] // NCF_BATCH   # the last, partial batch is dropped
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, losses = _ncf_train(DEV, x, y, Trigger.or_(
        Trigger.max_epoch(1), Trigger.max_iteration(NCF_MAX_ITER)))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    loss = [losses.loss[k] for k in sorted(losses.loss)]
    step_ms = steady_step_ms(losses.at, steps)
    t0 = time.perf_counter()
    hr, ndcg = X.eval_ranking(model, pos, NCF_ITEMS, device=DEV)
    eval_s = time.perf_counter() - t0
    _, cpu_losses = _ncf_train("cpu", x, y,
                               Trigger.max_iteration(NCF_CPU_STEPS))
    cpu = [cpu_losses.loss[k] for k in sorted(cpu_losses.loss)]
    rel = [abs(a - b) / abs(b) for a, b in zip(loss, cpu)]
    say(f"phase 18 (b) NCF {NCF_USERS} users x {NCF_ITEMS} items, "
        f"{x.shape[0]} rows ({data_s:.1f} s to make), batch {NCF_BATCH}, "
        f"Adam({NCF_LR:g}), f32: {len(loss)} steps in {train_s:.1f} s, "
        f"loss {loss[0]:.5f} -> {loss[-1]:.5f}; step {step_ms:.3f} ms "
        f"(median, wall), {NCF_BATCH / step_ms * 1e3:.0f} rows/s; "
        f"HitRatio@10 {hr:.4f}, NDCG@10 {ndcg:.4f} (random {NCF_HR_MIN}, "
        f"{NCF_NDCG_MIN}; {eval_s:.1f} s); first {len(cpu)} losses against "
        f"the CPU: worst relative gap {max(rel):.3e} (limit "
        f"{NCF_LOSS_REL_TOL:g})")
    if len(loss) != steps or not all(np.isfinite(loss)):
        raise AssertionError(f"NCF: {len(loss)} losses of {steps}, or "
                             "non-finite ones")
    if len(cpu) != NCF_CPU_STEPS or not max(rel) <= NCF_LOSS_REL_TOL:
        raise AssertionError(f"NCF losses off the CPU run's: {rel}")
    if not (hr > NCF_HR_MIN and ndcg > NCF_NDCG_MIN):
        raise AssertionError(f"NCF ranks no better than chance: HR {hr}, "
                             f"NDCG {ndcg}")


def _lm_optim_arm(cls, make, x, y):
    """(c): the flagship in f32 with the kernels, the token embedding
    frozen, trained by ``cls`` for 1 + ``LM_OPT_STEPS`` steps with the
    method ``make()``.  Returns (losses, params, launches, step ms of
    the timed steps, whether the embedding stayed bit-equal)."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.optim import DistriOptimizer, Trigger
    from bigdl_tpu_torch.utils import tree as T

    model = _lm("kernel", LM_T)
    model.child("wte").freeze()
    wte0 = model.child("wte").weight.detach().clone()
    RandomGenerator.RNG.set_seed(1)
    kw = dict(wire_dtype="float32") if cls is DistriOptimizer else {}
    opt = cls(model, (x, y), CrossEntropyCriterion(), x.shape[0], device=DEV,
              **kw)
    opt.set_optim_method(make())
    losses = _Losses()
    opt.set_train_summary(losses)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    opt.set_end_when(Trigger.max_iteration(1)).optimize()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    opt.set_end_when(Trigger.max_iteration(1 + LM_OPT_STEPS)).optimize()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / LM_OPT_STEPS * 1e3
    launches = {k: _cuda.launches[k]
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    out = ([losses.loss[k] for k in sorted(losses.loss)],
           [p.detach().clone() for p in T.leaves(model.params())], launches,
           ms, torch.equal(model.child("wte").weight, wte0))
    del opt, model
    torch.cuda.empty_cache()
    return out


def _phase_optim_lm() -> None:
    """(c): the flagship with Adam on the flash kernels."""
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.optim import (SGD, Adam, DistriOptimizer,
                                       LocalOptimizer, Step)

    def adam():
        m = Adam(learningrate=1e-3)
        m.learningrate_schedule = Step(2, 0.5)
        return m

    x, y = _lm_data(LM_BATCH, LM_T)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        local = _lm_optim_arm(LocalOptimizer, adam, x, y)
        distri = _lm_optim_arm(DistriOptimizer, adam, x, y)
        sgd = _lm_optim_arm(LocalOptimizer, lambda: SGD(learningrate=1e-3),
                            x, y)
    finally:
        torch.backends.cudnn.deterministic = det
        Engine.reset()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(distri[0], local[0]))
    num = sum(float(torch.sum((a - b) ** 2))
              for a, b in zip(distri[1], local[1]))
    den = sum(float(torch.sum(b ** 2)) for b in local[1])
    p_rel = (num / den) ** 0.5
    want = 8 * (1 + LM_OPT_STEPS)
    sgd11 = _LM_SGD_MS.get("kernel")
    say(f"phase 18 (c) flagship B={LM_BATCH} T={LM_T} f32, kernel attention, "
        f"wte frozen, Adam(1e-3) under Step(2, 0.5): Local losses "
        f"{['%.5f' % v for v in local[0]]}; Distri (world 1, NCCL, f32 wire) "
        f"against Local: losses {loss_rel:.3e}, params L2 {p_rel:.3e} "
        f"(limit {LM_DISTRI_TOL:g}); launches Local {local[2]}, Distri "
        f"{distri[2]} (want {want} each); wte bit-equal Local {local[4]}, "
        f"Distri {distri[4]}")
    say(f"phase 18 (c) step ms over steps 2-{1 + LM_OPT_STEPS}: Adam f32 "
        f"Local {local[3]:.3f}, Distri {distri[3]:.3f}; SGD f32 Local "
        f"{sgd[3]:.3f}; phase 11's SGD bf16 kernel arm "
        + (f"{sgd11:.3f}" if sgd11 is not None else "not run in this call"))
    if not all(np.isfinite(v) for v in local[0] + distri[0] + sgd[0]):
        raise AssertionError("flagship with Adam: non-finite losses")
    if not (local[4] and distri[4] and sgd[4]):
        raise AssertionError("the frozen token embedding moved")
    for arm in (local, distri, sgd):
        if tuple(arm[2].values()) != (want,) * 3:
            raise AssertionError(f"flagship launched {arm[2]}, want {want} "
                                 "each")
    if not (loss_rel <= LM_DISTRI_TOL and p_rel <= LM_DISTRI_TOL):
        raise AssertionError(f"Distri off Local: losses {loss_rel:.3e}, "
                             f"params {p_rel:.3e}")


def _ae_run(device):
    """``train_autoencoder`` for one epoch on ``device``, each loss
    recorded: (losses, step ms)."""
    from bigdl_tpu_torch import optim as O
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.autoencoder import train_autoencoder

    losses = _TimedLosses()
    base = O.LocalOptimizer

    class Recording(base):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.set_train_summary(losses)

    O.LocalOptimizer = Recording
    try:
        RandomGenerator.RNG.set_seed(0)
        _, opt = train_autoencoder(batch_size=AE_BATCH, max_epoch=1,
                                   learning_rate=AE_LR, device=device)
    finally:
        O.LocalOptimizer = base
    if type(opt.optim_method).__name__ != "Adagrad":
        raise AssertionError("train_autoencoder did not train with Adagrad")
    return [losses.loss[k] for k in sorted(losses.loss)], losses.at


def _phase_optim_autoencoder() -> None:
    """(d): the MNIST autoencoder with Adagrad."""
    card, at = _ae_run(DEV)
    cpu, _ = _ae_run("cpu")
    rel = [abs(a - b) / abs(b) for a, b in zip(card, cpu)]
    steps = len(card)
    say(f"phase 18 (d) autoencoder 784-32-784, Adagrad({AE_LR:g}), batch "
        f"{AE_BATCH}, f32, synthetic MNIST: {steps} steps, loss "
        f"{card[0]:.6f} -> {card[-1]:.6f}; step "
        f"{steady_step_ms(at, steps):.3f} ms (median, wall); card against "
        f"CPU relative gaps {['%.1e' % r for r in rel]} (first "
        f"{AE_CPU_LOSSES} gated at {AE_LOSS_REL_TOL:g})")
    if len(cpu) != steps or not all(np.isfinite(card)):
        raise AssertionError("autoencoder: missing or non-finite losses")
    if not card[-1] < card[0]:
        raise AssertionError(f"autoencoder loss did not fall: {card}")
    if not max(rel[:AE_CPU_LOSSES]) <= AE_LOSS_REL_TOL:
        raise AssertionError(f"autoencoder losses off the CPU's: {rel}")


def _reg_model(device):
    """(e): LookupTable → Recurrent(LSTM) → a 3x3 conv over the (T, H)
    sequence → Linear → LogSoftMax, each trained layer with an
    ``L1L2Regularizer``, from seed 0."""
    from bigdl_tpu_torch import nn as N
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.optim import L1L2Regularizer

    RandomGenerator.RNG.set_seed(0)
    reg = lambda: L1L2Regularizer(1e-5, 1e-4)  # noqa: E731
    return N.Sequential() \
        .add(N.LookupTable(REG_VOCAB, REG_EMBED, w_regularizer=reg())) \
        .add(N.Recurrent().add(N.LSTM(
            REG_EMBED, REG_HIDDEN, w_regularizer=reg(), u_regularizer=reg(),
            b_regularizer=reg()))) \
        .add(N.Reshape([1, REG_T, REG_HIDDEN])) \
        .add(N.SpatialConvolution(1, 4, 3, 3, 1, 1, 1, 1,
                                  w_regularizer=reg(), b_regularizer=reg())) \
        .add(N.Reshape([4 * REG_T * REG_HIDDEN])) \
        .add(N.Linear(4 * REG_T * REG_HIDDEN, 10, w_regularizer=reg(),
                      b_regularizer=reg())) \
        .add(N.LogSoftMax()).to(device)


def _phase_optim_regularizers() -> None:
    """(e): 3 steps of the regularized model on the card and the CPU."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger

    rs = np.random.RandomState(18)
    x = (rs.randint(0, REG_VOCAB, (REG_BATCH * REG_STEPS, REG_T)) + 1) \
        .astype(np.float32)
    y = (rs.randint(0, 10, REG_BATCH * REG_STEPS) + 1).astype(np.float32)
    res = {}
    for dev in (DEV, "cpu"):
        model = _reg_model(dev)
        RandomGenerator.RNG.set_seed(1)
        losses = _Losses()
        opt = LocalOptimizer(model, (x, y), ClassNLLCriterion(), REG_BATCH,
                             device=dev)
        opt.set_optim_method(Adam(learningrate=1e-3))
        opt.set_end_when(Trigger.max_iteration(REG_STEPS))
        opt.set_train_summary(losses).optimize()
        res[dev] = ([losses.loss[k] for k in sorted(losses.loss)],
                    float(model.regularization_loss().detach()))
    card, cpu = res[DEV], res["cpu"]
    rel = [abs(a - b) / abs(b) for a, b in zip(card[0] + [card[1]],
                                               cpu[0] + [cpu[1]])]
    say(f"phase 18 (e) LookupTable/LSTM/SpatialConvolution/Linear with "
        f"L1L2Regularizer, {REG_STEPS} Adam steps: losses "
        f"{['%.6f' % v for v in card[0]]}, regularization_loss "
        f"{card[1]:.6f}; card against CPU worst relative gap {max(rel):.3e} "
        f"(limit {REG_REL_TOL:g})")
    if len(card[0]) != REG_STEPS or not max(rel) <= REG_REL_TOL:
        raise AssertionError(f"regularized model off the CPU's: {rel}")


def phase_optim(smi: str) -> None:
    """Phase 18: the optim methods, schedules, regularizers and freeze;
    callable alone after ``phase_device()`` (the flash kernels build on
    their first launch without ``phase_build()``)."""
    t_phase = time.perf_counter()
    parts = {}
    for part, run in (("a", _phase_optim_steps), ("b", _phase_optim_ncf),
                      ("c", _phase_optim_lm),
                      ("d", _phase_optim_autoencoder),
                      ("e", _phase_optim_regularizers)):
        t0 = time.perf_counter()
        run()
        parts[part] = round(time.perf_counter() - t0, 1)
    say(f"phase 18 took {time.perf_counter() - t_phase:.1f} s on {smi} "
        f"(seconds by part {parts})")


def phase_serving_http(smi: str, direct_ttft: float) -> None:
    """Phase 17: the serving tier over HTTP at full width: (a) LMEngine
    (the flagship) and ClassifierEngine (ResNet-50) behind one
    ServingServer; (b) int8; (c) drain and replay; (d) swap_weights;
    (e) backpressure; (f) BASELINE config 5."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.resnet import build_resnet_imagenet
    from bigdl_tpu_torch.serving import ClassifierEngine, ServingServer

    t_phase = time.perf_counter()
    model = _flagship(0)
    RandomGenerator.RNG.set_seed(0)
    resnet = build_resnet_imagenet(50, 1000, device=DEV).evaluate()
    images = np.random.RandomState(3).randn(
        SERVE_IMAGES, 3, 224, 224).astype(np.float32)
    lm = _lm_engine(model).start()
    clf = ClassifierEngine(resnet, max_batch=SERVE_IMAGES,
                           device=DEV).start()
    srv = ServingServer(lm=lm, classifier=clf, port=0)
    try:
        toks, ref = _serve_http(srv, model, resnet, images, direct_ttft)
        float_stats = lm.stats()
        replay = _drain_over_http(srv, lm, model, toks)
    finally:
        srv.close()
        lm.close()
        clf.close()
    _int8_mm_checks()
    _int8_serving(model, toks, float_stats, resnet, images, ref)
    _swap_over_http(replay)
    _backpressure(model)
    del model, resnet
    torch.cuda.empty_cache()
    _config5()
    print(smi, flush=True)
    say(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")


# ---- phase 19: the text CNN and the rest of the criterions, layers and
# table ops ------------------------------------------------------------------
def _tc(shape, seed, scale=1.0, lo=None, hi=None):
    """f32 numpy input of ``shape`` from ``seed``: normal times ``scale``,
    or uniform in [lo, hi)."""
    rs = np.random.RandomState(seed)
    if lo is not None:
        return rs.uniform(lo, hi, shape).astype(np.float32)
    return (scale * rs.randn(*shape)).astype(np.float32)


def _tc_ids(shape, hi, seed=1):
    """1-based float32 ids in [1, hi]."""
    return (np.random.RandomState(seed).randint(0, hi, shape) + 1).astype(
        np.float32)


def _tc_pm1(shape, seed=1):
    return np.where(np.random.RandomState(seed).rand(*shape) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _tc_bits(shape, seed=1):
    return (np.random.RandomState(seed).rand(*shape) < 0.5).astype(
        np.float32)


def _tc_multilabel():
    t = _tc_ids((1024, 100), 100, seed=2)
    t[:, 5:] = 0.0
    t[::3, 2] = 0.0                          # a nonzero entry after a 0
    return t


def _tc_logp(shape, seed=0):
    x = _tc(shape, seed)
    return (x - np.log(np.exp(x).sum(-1, keepdims=True))).astype(np.float32)


# Phase 19 (d)'s cases at about 1e5 elements an input: (family, name,
# build function over the port's nn, input maker, target maker (None: a
# module), exact outputs)
ITEM14_E = (256, 400)
ITEM14_CASES = [
    ("conv", "TemporalConvolution", lambda N: N.TemporalConvolution(
        32, 64, 5), lambda: _tc((32, 100, 32), 0), None, False),
    ("conv", "SpatialConvolution SAME s1", lambda N: N.SpatialConvolution(
        16, 32, 3, 3, 1, 1, -1, -1), lambda: _tc((8, 16, 28, 28), 0), None,
     False),
    ("conv", "SpatialConvolution SAME s2", lambda N: N.SpatialConvolution(
        16, 32, 3, 3, 2, 2, -1, -1), lambda: _tc((8, 16, 28, 28), 0), None,
     False),
    ("conv", "ConvLSTMPeephole", lambda N: N.Recurrent().add(
        N.ConvLSTMPeephole(16, 32)), lambda: _tc((4, 8, 16, 32, 32), 0),
     None, False),
    ("reduce", "Max", lambda N: N.Max(2), lambda: _tc((64, 40, 40), 0), None,
     False),
    ("reduce", "Min", lambda N: N.Min(2), lambda: _tc((64, 40, 40), 0), None,
     False),
    ("reduce", "Mean", lambda N: N.Mean(2), lambda: _tc((64, 40, 40), 0),
     None, False),
    ("reduce", "Sum", lambda N: N.Sum(2, -1, True),
     lambda: _tc((64, 40, 40), 0), None, False),
] + [("elementwise", name, build, make, None, exact)
     for name, build, make, exact in [
    ("ReLU6", lambda N: N.ReLU6(), lambda: _tc(ITEM14_E, 0, 5.0), False),
    ("HardTanh", lambda N: N.HardTanh(-0.5, 0.7), lambda: _tc(ITEM14_E, 0),
     False),
    ("Clamp", lambda N: N.Clamp(-0.3, 0.4), lambda: _tc(ITEM14_E, 0), False),
    ("Threshold", lambda N: N.Threshold(0.1, -2.0), lambda: _tc(ITEM14_E, 0),
     False),
    ("HardSigmoid", lambda N: N.HardSigmoid(), lambda: _tc(ITEM14_E, 0, 4.0),
     False),
    ("SoftMin", lambda N: N.SoftMin(), lambda: _tc(ITEM14_E, 0), False),
    ("SoftSign", lambda N: N.SoftSign(), lambda: _tc(ITEM14_E, 0), False),
    ("GELU", lambda N: N.GELU(), lambda: _tc(ITEM14_E, 0, 2.0), False),
    ("SELU", lambda N: N.SELU(), lambda: _tc(ITEM14_E, 0), False),
    ("Square", lambda N: N.Square(), lambda: _tc(ITEM14_E, 0), False),
    ("Sqrt", lambda N: N.Sqrt(), lambda: _tc(ITEM14_E, 0, lo=0.1, hi=3.0),
     False),
    ("Negative", lambda N: N.Negative(), lambda: _tc(ITEM14_E, 0), False),
    ("Floor", lambda N: N.Floor(), lambda: _tc(ITEM14_E, 0, 3.0), True),
    ("Ceil", lambda N: N.Ceil(), lambda: _tc(ITEM14_E, 0, 3.0), True),
    ("Round", lambda N: N.Round(), lambda: np.round(
        _tc(ITEM14_E, 0, 3.0) * 2) / 2, True),
    ("Sign", lambda N: N.Sign(), lambda: np.round(_tc(ITEM14_E, 0)), True),
    ("Log1p", lambda N: N.Log1p(), lambda: _tc(ITEM14_E, 0, lo=0.0, hi=3.0),
     False),
    ("Expm1", lambda N: N.Expm1(), lambda: _tc(ITEM14_E, 0), False),
    ("Erf", lambda N: N.Erf(), lambda: _tc(ITEM14_E, 0), False),
    ("Sin", lambda N: N.Sin(), lambda: _tc(ITEM14_E, 0, 3.0), False),
    ("Cos", lambda N: N.Cos(), lambda: _tc(ITEM14_E, 0, 3.0), False),
    ("ArgMax", lambda N: N.ArgMax(2), lambda: _tc(ITEM14_E, 0), True),
    ("AddConstant", lambda N: N.AddConstant(1.5), lambda: _tc(ITEM14_E, 0),
     False),
    ("DivConstant", lambda N: N.DivConstant(3.0), lambda: _tc(ITEM14_E, 0),
     False),
    ("MulConstant", lambda N: N.MulConstant(-2.5), lambda: _tc(ITEM14_E, 0),
     False)]] + [("learnable", name, build, make, None, False)
                 for name, build, make in [
    ("CMul", lambda N: N.CMul([1, 400]), lambda: _tc(ITEM14_E, 0)),
    ("CAdd", lambda N: N.CAdd([1, 400]), lambda: _tc(ITEM14_E, 0)),
    ("Add", lambda N: N.Add(400), lambda: _tc(ITEM14_E, 0)),
    ("Mul", lambda N: N.Mul(), lambda: _tc(ITEM14_E, 0)),
    ("Cosine", lambda N: N.Cosine(100, 64), lambda: _tc((1024, 100), 0)),
    ("Euclidean", lambda N: N.Euclidean(100, 64),
     lambda: _tc((1024, 100), 0)),
    ("Bilinear", lambda N: N.Bilinear(100, 100, 10),
     lambda: (_tc((1024, 100), 0), _tc((1024, 100), 1)))]] + [
    ("shape", name, build, make, None, exact)
    for name, build, make, exact in [
    ("Squeeze", lambda N: N.Squeeze(2), lambda: _tc((256, 1, 400), 0),
     False),
    ("Unsqueeze", lambda N: N.Unsqueeze(2), lambda: _tc(ITEM14_E, 0), False),
    ("Transpose", lambda N: N.Transpose([[1, 3], [2, 3]]),
     lambda: _tc((64, 40, 40), 0), False),
    ("Contiguous", lambda N: N.Contiguous(), lambda: _tc(ITEM14_E, 0),
     False),
    ("Replicate", lambda N: N.Replicate(3, 2), lambda: _tc(ITEM14_E, 0),
     False),
    ("Narrow", lambda N: N.Narrow(2, 11, 300), lambda: _tc(ITEM14_E, 0),
     False),
    ("Padding", lambda N: N.Padding(1, -7, 1, 0.5),
     lambda: _tc(ITEM14_E, 0), False),
    ("SpatialZeroPadding", lambda N: N.SpatialZeroPadding(1, 2, 0, 3),
     lambda: _tc((8, 16, 28, 28), 0), False),
    ("Index", lambda N: N.Index(1), lambda: (_tc(ITEM14_E, 0),
                                              _tc_ids((300,), 256)), True),
    ("Masking", lambda N: N.Masking(0.0), lambda: np.where(
        _tc((64, 40, 1), 1) > 0.5, 0.0, _tc((64, 40, 40), 0)).astype(
        np.float32), False)]] + [
    ("resample+normalize", "SpatialUpSamplingNearest",
     lambda N: N.SpatialUpSamplingNearest(2),
     lambda: _tc((8, 16, 28, 28), 0), None, False),
    ("resample+normalize", "SpatialUpSamplingBilinear up",
     lambda N: N.SpatialUpSamplingBilinear(56, 70),
     lambda: _tc((8, 16, 28, 28), 0), None, False),
    ("resample+normalize", "SpatialUpSamplingBilinear down",
     lambda N: N.SpatialUpSamplingBilinear(9, 11),
     lambda: _tc((8, 16, 28, 28), 0), None, False),
    ("resample+normalize", "Normalize", lambda N: N.Normalize(2.0),
     lambda: _tc(ITEM14_E, 0), None, False),
    ("resample+normalize", "Normalize inf",
     lambda N: N.Normalize(float("inf")), lambda: _tc(ITEM14_E, 0), None,
     False),
    ("gradient-shaping", "GradientReversal",
     lambda N: N.GradientReversal(0.7), lambda: _tc(ITEM14_E, 0), None,
     False),
    ("gradient-shaping", "L1Penalty", lambda N: N.L1Penalty(0.3, True),
     lambda: _tc(ITEM14_E, 0), None, False),
] + [("table", name, build, make, None, exact)
     for name, build, make, exact in [
    ("ParallelTable", lambda N: N.ParallelTable().add(N.Linear(400, 64))
     .add(N.Tanh()), lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False),
    ("MapTable", lambda N: N.MapTable(N.BatchNormalization(400)),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1, 2.0)), False),
    ("Bottle", lambda N: N.Bottle(N.Linear(40, 64)),
     lambda: _tc((64, 40, 40), 0), False),
    ("SelectTable", lambda N: N.SelectTable(2),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False),
    ("NarrowTable", lambda N: N.NarrowTable(2, 2),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1), _tc(ITEM14_E, 2)), False),
    ("FlattenTable", lambda N: N.FlattenTable(),
     lambda: (_tc(ITEM14_E, 0), (_tc(ITEM14_E, 1), _tc(ITEM14_E, 2))),
     False),
    ("SplitTable", lambda N: N.SplitTable(2), lambda: _tc((64, 40, 40), 0),
     False),
    ("BifurcateSplitTable", lambda N: N.BifurcateSplitTable(2),
     lambda: _tc(ITEM14_E, 0), False),
    ("Pack", lambda N: N.Pack(2), lambda: (_tc(ITEM14_E, 0),
                                            _tc(ITEM14_E, 1)), False),
    ("CSubTable", lambda N: N.CSubTable(),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False),
    ("CDivTable", lambda N: N.CDivTable(),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1, lo=0.5, hi=2.0)), False),
    ("CMinTable", lambda N: N.CMinTable(),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False),
    ("CAveTable", lambda N: N.CAveTable(),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False),
    ("MM", lambda N: N.MM(False, True),
     lambda: (_tc((64, 40, 40), 0), _tc((64, 40, 40), 1)), False),
    ("MV", lambda N: N.MV(True), lambda: (_tc((256, 20, 20), 0),
                                           _tc((256, 20), 1)), False),
    ("DotProduct", lambda N: N.DotProduct(),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False),
    ("CosineDistance", lambda N: N.CosineDistance(),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False),
    ("MixtureTable", lambda N: N.MixtureTable(),
     lambda: (_tc((1024, 4), 0), _tc((1024, 4, 100), 1)), False),
    ("InTopK", lambda N: N.InTopK(5), lambda: (
        _tc((1024, 100), 0), _tc_ids((1024,), 100) - 1.0), True),
    ("WhereTable", lambda N: N.WhereTable(True), lambda: (
        _tc_bits((256,)), _tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False)]] + [
    ("criterion", name, build, make, target, False)
    for name, build, make, target in [
    ("AbsCriterion", lambda N: N.AbsCriterion(), lambda: _tc((512, 200), 0),
     lambda: _tc((512, 200), 1)),
    ("SmoothL1Criterion", lambda N: N.SmoothL1Criterion(),
     lambda: _tc((512, 200), 0, 2.0), lambda: _tc((512, 200), 1)),
    ("BCECriterion", lambda N: N.BCECriterion(),
     lambda: _tc((512, 200), 0, lo=0.02, hi=0.98),
     lambda: _tc_bits((512, 200))),
    ("BCECriterionWithLogits", lambda N: N.BCECriterionWithLogits(),
     lambda: _tc((512, 200), 0, 3.0), lambda: _tc_bits((512, 200))),
    ("MultiLabelSoftMarginCriterion",
     lambda N: N.MultiLabelSoftMarginCriterion(),
     lambda: _tc((512, 200), 0), lambda: _tc_bits((512, 200))),
    ("MarginCriterion", lambda N: N.MarginCriterion(0.5, True, True),
     lambda: _tc((512, 200), 0), lambda: _tc_pm1((512, 200))),
    ("HingeEmbeddingCriterion", lambda N: N.HingeEmbeddingCriterion(1.5),
     lambda: _tc((512, 200), 0, lo=0.0, hi=2.0),
     lambda: _tc_pm1((512, 200))),
    ("DistKLDivCriterion", lambda N: N.DistKLDivCriterion(),
     lambda: _tc_logp((512, 200)), lambda: _tc((512, 200), 1, lo=0.0,
                                               hi=1.0)),
    ("CosineEmbeddingCriterion", lambda N: N.CosineEmbeddingCriterion(0.1),
     lambda: (_tc((1024, 100), 0), _tc((1024, 100), 1)),
     lambda: _tc_pm1((1024,))),
    ("SoftmaxWithCriterion", lambda N: N.SoftmaxWithCriterion(3),
     lambda: _tc((8, 16, 28, 28), 0), lambda: _tc_ids((8, 28, 28), 16)),
    ("MultiCriterion", lambda N: N.MultiCriterion().add(N.MSECriterion(),
                                                         0.5)
     .add(N.AbsCriterion()), lambda: _tc((512, 200), 0),
     lambda: _tc((512, 200), 1)),
    ("ParallelCriterion", lambda N: N.ParallelCriterion(True)
     .add(N.MSECriterion()).add(N.AbsCriterion(), 2.0),
     lambda: (_tc((512, 200), 0), _tc((512, 200), 2)),
     lambda: _tc((512, 200), 1)),
    ("ClassSimplexCriterion", lambda N: N.ClassSimplexCriterion(100),
     lambda: _tc((1024, 100), 0), lambda: _tc_ids((1024,), 100)),
    ("L1Cost", lambda N: N.L1Cost(), lambda: _tc((512, 200), 0),
     lambda: _tc((512, 200), 1)),
    ("MarginRankingCriterion", lambda N: N.MarginRankingCriterion(0.5),
     lambda: (_tc((102400,), 0), _tc((102400,), 1)),
     lambda: _tc_pm1((102400,))),
    ("MultiMarginCriterion", lambda N: N.MultiMarginCriterion(2),
     lambda: _tc((1024, 100), 0), lambda: _tc_ids((1024,), 100)),
    ("CosineDistanceCriterion", lambda N: N.CosineDistanceCriterion(),
     lambda: _tc((1024, 100), 0), lambda: _tc((1024, 100), 1)),
    ("DiceCoefficientCriterion", lambda N: N.DiceCoefficientCriterion(),
     lambda: _tc((64, 40, 40), 0, lo=0.0, hi=1.0),
     lambda: _tc_bits((64, 40, 40))),
    ("SoftMarginCriterion", lambda N: N.SoftMarginCriterion(),
     lambda: _tc((512, 200), 0, 3.0), lambda: _tc_pm1((512, 200))),
    ("MultiLabelMarginCriterion", lambda N: N.MultiLabelMarginCriterion(),
     lambda: _tc((1024, 100), 0), _tc_multilabel),
    ("GaussianCriterion", lambda N: N.GaussianCriterion(),
     lambda: (_tc((512, 200), 0), _tc((512, 200), 2, 0.5)),
     lambda: _tc((512, 200), 1)),
    ("KLDCriterion", lambda N: N.KLDCriterion(),
     lambda: (_tc((512, 200), 0), _tc((512, 200), 2, 0.5)),
     lambda: _tc((512, 200), 1)),
    ("L1HingeEmbeddingCriterion", lambda N: N.L1HingeEmbeddingCriterion(
        20.0), lambda: (_tc((1024, 100), 0), _tc((1024, 100), 1)),
     lambda: _tc_pm1((1024,))),
    ("PoissonCriterion", lambda N: N.PoissonCriterion(),
     lambda: _tc((512, 200), 0, lo=0.05, hi=3.0),
     lambda: _tc((512, 200), 1, lo=0.0, hi=3.0)),
    ("CosineProximityCriterion", lambda N: N.CosineProximityCriterion(),
     lambda: _tc((1024, 100), 0), lambda: _tc((1024, 100), 1)),
    ("MeanAbsolutePercentageCriterion",
     lambda N: N.MeanAbsolutePercentageCriterion(),
     lambda: _tc((512, 200), 0), lambda: _tc((512, 200), 1, lo=0.5,
                                             hi=2.0)),
    ("MeanSquaredLogarithmicCriterion",
     lambda N: N.MeanSquaredLogarithmicCriterion(),
     lambda: _tc((512, 200), 0, lo=0.0, hi=3.0),
     lambda: _tc((512, 200), 1, lo=0.0, hi=3.0))]]


def _tmap(fn, t):
    if isinstance(t, (tuple, list)):
        return tuple(_tmap(fn, u) for u in t)
    return fn(t)


def _tleaves(t) -> list:
    if isinstance(t, (tuple, list)):
        return [leaf for u in t for leaf in _tleaves(u)]
    return [t]


def _item14_run(m, make, target, device, dtype=torch.float32):
    """One case's forward and backward on ``device``, the float inputs
    and targets in ``dtype``: (outputs, input gradients, parameter
    gradients), all on the host."""
    def put(a):
        if not isinstance(a, np.ndarray):
            return a                    # a SparseTensor stays on the host
        return torch.tensor(a, device=device, dtype=dtype,
                            requires_grad=True)

    xs = _tmap(put, make())
    if target is not None:
        outs = [m.loss(xs, _tmap(lambda a: torch.as_tensor(
            a, device=device, dtype=dtype), target()))]
    else:
        outs = _tleaves(m(xs))
    rs = np.random.RandomState(190)
    total = None
    for o in outs:
        if o.requires_grad:
            cot = torch.as_tensor(np.asarray(rs.randn(*o.shape), np.float32),
                                  device=device).to(o.dtype)
            part = (o * cot).sum()
            total = part if total is None else total + part
    if total is not None:
        total.backward()

    def host(g, like):
        return (g if g is not None else torch.zeros_like(like)).detach().cpu()

    params = list(m.parameters()) if isinstance(m, torch.nn.Module) else []
    return ([o.detach().cpu() for o in outs],
            [host(x.grad, x) for x in _tleaves(xs)
             if isinstance(x, torch.Tensor)],
            [host(p.grad, p) for p in params])


def _ulp_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """What |a - b| exceeds one f32 ulp of b by, over the largest |b|."""
    b32 = b.float()
    over = ((a.double() - b.double()).abs() - _ulp(b32).double()) \
        .clamp_min(0.0).max().item()
    return over / max(b32.abs().max().item(), 1e-30)


def _item14_case(build, make, target, exact) -> tuple:
    """(worst gap, card against CPU, over the outputs and the input and
    parameter gradients; per tensor (what, that gap, the card's and the
    CPU's gaps to the same case in f64 on the CPU)).  Integer outputs
    must be equal."""
    import copy

    from bigdl_tpu_torch import nn as TN
    from bigdl_tpu_torch.common import RandomGenerator

    RandomGenerator.RNG.set_seed(19)
    cpu_m = build(TN)
    card_m, ref_m = copy.deepcopy(cpu_m), copy.deepcopy(cpu_m)
    if isinstance(cpu_m, torch.nn.Module):
        card_m.to(DEV)
        ref_m.double()
    card = _item14_run(card_m, make, target, DEV)
    cpu = _item14_run(cpu_m, make, target, "cpu")
    ref = _item14_run(ref_m, make, target, "cpu", torch.float64)
    names = ["output", "input gradient", "parameter gradient"]
    worst, rows = 0.0, []
    for k in range(3):
        if len(card[k]) != len(cpu[k]):
            raise AssertionError("card and CPU differ in their outputs")
        for i, (a, b, r) in enumerate(zip(card[k], cpu[k], ref[k])):
            if k == 0 and exact:
                if not torch.equal(a, b):
                    raise AssertionError("integer outputs differ")
                continue
            if not torch.isfinite(a).all():
                raise AssertionError("non-finite values on the card")
            gap = _ulp_gap(a, b)
            worst = max(worst, gap)
            rows.append((f"{names[k]} {i}", gap, _ulp_gap(a, r),
                         _ulp_gap(b, r)))
    return worst, rows


def _phase_text_cnn_main():
    """(a): the example's ``main`` at its defaults on the card and on the
    CPU.  Returns the card's trainer."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.examples import train_text_cnn as X
    from bigdl_tpu_torch.ops import _cuda

    argv = ["-b", str(TC_BATCH), "-e", str(TC_EPOCHS), "--learning-rate",
            str(TC_LR), "--doc-len", str(TC_DOC_LEN)]
    runs = {}
    kernels_before = _model_launches()
    threads = torch.get_num_threads()
    # the CPU run, then the same run on one thread (another f32 summation
    # order): the control that shows how far the recipe itself carries
    # a last-bit difference
    for run, dev in ((DEV, DEV), ("cpu", "cpu"), ("cpu1", "cpu")):
        torch.set_num_threads(1 if run == "cpu1" else threads)
        RandomGenerator.RNG.set_seed(0)
        losses, vals = _TimedLosses(), _Scalars()
        t0 = time.perf_counter()
        opt = X.main(argv + ["--device", dev], train_summary=losses,
                     val_summary=vals)
        if dev == DEV:
            torch.cuda.synchronize()
        runs[run] = (opt, [losses.loss[n] for n in sorted(losses.loss)],
                     [v for t, _, v in vals.rows if t == "Top1Accuracy"],
                     losses.at, time.perf_counter() - t0)
    torch.set_num_threads(threads)
    opt, loss, top1, at, secs = runs[DEV]
    _, cpu_loss, cpu_top1, _, cpu_secs = runs["cpu"]
    control = runs["cpu1"][1]
    per_epoch = len(loss) // TC_EPOCHS
    gaps = sorted(at[n + 1] - at[n] for n in sorted(at)
                  if n >= 2 and n + 1 in at
                  and (n - 1) % per_epoch <= per_epoch - 3)
    step_ms = steady_step_ms(at, per_epoch)
    n = TC_CPU_STEPS
    rel = [abs(a - b) / abs(b) for a, b in zip(loss[:n], cpu_loss[:n])]
    ctl = [abs(a - b) / abs(b) for a, b in zip(control[:n], cpu_loss[:n])]
    scaled = [abs(a - b) / abs(cpu_loss[0])
              for a, b in zip(loss[:n], cpu_loss[:n])]
    say(f"phase 19 (a) train_text_cnn.main {' '.join(argv)}: the "
        f"synthetic_news20(1536, 4) stand-in, embed 32, 64 filters, k 5, "
        f"{len(loss)} Adam steps in {secs:.1f} s; losses "
        f"{['%.3e' % v for v in loss]}; validation Top1 by epoch card "
        f"{['%.4f' % v for v in top1]}, CPU {['%.4f' % v for v in cpu_top1]} "
        f"({cpu_secs:.1f} s)")
    say(f"phase 19 (a) step {step_ms:.3f} ms (median over steps 2-end, "
        f"wall; range {gaps[0] * 1e3:.3f}-{gaps[-1] * 1e3:.3f} ms), "
        f"{TC_BATCH * TC_DOC_LEN / step_ms * 1e3:.0f} tokens/s")
    say(f"phase 19 (a) first {n} losses, |card - CPU| over the CPU's first "
        f"loss: worst {max(scaled):.3e} at step "
        f"{int(np.argmax(scaled)) + 1} (limit {TC_LOSS_TOL:g}); relative "
        f"to each loss {['%.1e' % v for v in rel]}; the CPU on one thread "
        f"against the CPU, relative {['%.1e' % v for v in ctl]}")
    if len(loss) != len(cpu_loss) or not all(np.isfinite(loss)):
        raise AssertionError(f"text CNN: missing or non-finite losses {loss}")
    if len(scaled) != n or not max(scaled) <= TC_LOSS_TOL:
        raise AssertionError(f"text CNN losses off the CPU's: {scaled}")
    if len(top1) != TC_EPOCHS or not top1[-1] >= TC_TOP1_MIN or not (
            abs(top1[-1] - cpu_top1[-1]) <= TC_TOP1_GAP):
        raise AssertionError(f"text CNN Top1 card {top1}, CPU {cpu_top1}")
    if _model_launches() != kernels_before:
        raise AssertionError("the text CNN launched a kernel of csrc/")
    return opt


def _phase_text_cnn_news20_shape() -> None:
    """(b): the news20 shape (vocab 20001, 20 classes, 128 tokens) on
    random ids, for speed only."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset.news20 import CLASS_NUM
    from bigdl_tpu_torch.examples.train_text_cnn import build_text_cnn
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger

    gen = torch.Generator().manual_seed(19)
    n = TC_NEWS_BATCH * TC_NEWS_STEPS
    x = torch.randint(1, TC_NEWS_VOCAB + 1, (n, TC_NEWS_DOC_LEN),
                      generator=gen).float().numpy()
    y = torch.randint(1, CLASS_NUM + 1, (n,), generator=gen).float().numpy()
    RandomGenerator.RNG.set_seed(0)
    model = build_text_cnn(vocab=TC_NEWS_VOCAB, n_classes=CLASS_NUM,
                           doc_len=TC_NEWS_DOC_LEN, device=DEV)
    torch.cuda.reset_peak_memory_stats()
    losses = _TimedLosses()
    opt = LocalOptimizer(model, (x, y), ClassNLLCriterion(), TC_NEWS_BATCH,
                         device=DEV)
    opt.set_optim_method(Adam(learningrate=TC_LR))
    opt.set_end_when(Trigger.max_iteration(TC_NEWS_STEPS))
    opt.set_train_summary(losses).optimize()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    loss = [losses.loss[k] for k in sorted(losses.loss)]
    step_ms = steady_step_ms(losses.at, TC_NEWS_STEPS)
    say(f"phase 19 (b) the news20 shape on random ids (a stand-in for the "
        f"corpus, no accuracy): vocab {TC_NEWS_VOCAB}, {CLASS_NUM} classes, "
        f"doc_len {TC_NEWS_DOC_LEN}, batch {TC_NEWS_BATCH}, {len(loss)} "
        f"Adam steps: step {step_ms:.3f} ms (median, wall), "
        f"{TC_NEWS_BATCH * TC_NEWS_DOC_LEN / step_ms * 1e3:.0f} tokens/s, "
        f"peak memory {peak:.1f} MiB")
    if len(loss) != TC_NEWS_STEPS or not all(np.isfinite(loss)):
        raise AssertionError(f"news20-shape run: losses {loss}")
    phase_train_profile(opt, 19, "news20-shape text CNN step")


def _phase_text_cnn_serving(opt) -> None:
    """(c): (a)'s model as the UDF and through DLClassifierModel, on the
    card and, from the same weights, on the CPU."""
    from bigdl_tpu_torch.dataset.news20 import synthetic_news20
    from bigdl_tpu_torch.dlframes import DLClassifierModel
    from bigdl_tpu_torch.examples.train_text_cnn import (build_text_cnn,
                                                         encode_texts,
                                                         tokenize_corpus)
    from bigdl_tpu_torch.examples.udf_predict import make_predict_udf
    from bigdl_tpu_torch.optim.evaluator import predict

    docs = synthetic_news20(1536, class_num=4)
    _, _, dic = tokenize_corpus(docs, TC_DOC_LEN)
    texts = [d for d, _ in docs]
    model = opt.model
    cpu_model = build_text_cnn(len(dic) + 1, n_classes=4,
                               doc_len=TC_DOC_LEN, device="cpu")
    cpu_model.set_params(model.params())
    udf = make_predict_udf(model, dic, TC_DOC_LEN, DEV)
    udf(texts[:64])
    t0 = time.perf_counter()
    ids = udf(texts)
    udf_s = time.perf_counter() - t0
    feats = encode_texts(texts, dic, TC_DOC_LEN)
    df = {"text": texts, "features": [row for row in feats]}
    dl = DLClassifierModel(model, feature_size=[TC_DOC_LEN], device=DEV)
    t0 = time.perf_counter()
    preds = np.asarray(dl.transform(df)["prediction"])
    dl_s = time.perf_counter() - t0
    cpu_ids = make_predict_udf(cpu_model, dic, TC_DOC_LEN, "cpu")(texts)
    lp = predict(model, feats, device=DEV)
    cpu_lp = predict(cpu_model, feats, device="cpu")
    lp_gap = float(np.abs(lp - cpu_lp).max())
    lp_mag = float(np.abs(cpu_lp).max())
    acc = float(np.mean(ids == np.asarray([lab for _, lab in docs])))
    say(f"phase 19 (c) {len(texts)} rows: UDF {len(texts) / udf_s:.0f} "
        f"rows/s, DLClassifierModel.transform {len(texts) / dl_s:.0f} rows/s; "
        f"ids UDF = transform {bool((ids == preds).all())}, = CPU model's "
        f"{bool((ids == cpu_ids).all())}; log-probabilities card against CPU "
        f"max |gap| {lp_gap:.3e} (limit {TC_LOGP_TOL:g} x max(1, "
        f"{lp_mag:.2f})); UDF accuracy {acc:.4f}")
    if not (ids == preds).all() or not (ids == cpu_ids).all():
        raise AssertionError("the UDF, transform and CPU class ids differ")
    if not lp_gap <= TC_LOGP_TOL * max(1.0, lp_mag):
        raise AssertionError(f"log-probabilities off the CPU's by {lp_gap}")


def _phase_item14() -> None:
    """(d): every class of the slice, forward and backward on the card
    against the CPU (and both against the CPU in f64)."""
    worst = {}
    for family, name, build, make, target, exact in ITEM14_CASES:
        limit = ITEM14_CONV_TOL if family == "conv" else ITEM14_TOL
        gap, rows = _item14_case(build, make, target, exact)
        for what, g, g_card, g_cpu in rows:
            if g > 1e-6:
                say(f"phase 19 (d) {name} {what}: card - CPU {g:.3e}; "
                    f"against f64 card {g_card:.3e}, CPU {g_cpu:.3e}")
        if not gap <= limit:
            raise AssertionError(f"{name}: card off the CPU by {gap:.3e}")
        n, w, at = worst.get(family, (0, -1.0, ""))
        worst[family] = (n + 1, max(w, gap), name if gap > w else at)
    for family, (n, w, at) in worst.items():
        limit = ITEM14_CONV_TOL if family == "conv" else ITEM14_TOL
        say(f"phase 19 (d) {family}: {n} cases, worst gap beyond an ulp "
            f"{w:.3e} of the largest magnitude ({at}; limit {limit:g})")


def phase_text_cnn(smi: str) -> None:
    """Phase 19: the text CNN trained and served, and the rest of the
    criterions, layers and table ops on the card; callable alone after
    ``phase_device()``.  f32, TF32 off, cuDNN deterministic."""
    from bigdl_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    kernels_before = _model_launches()
    parts = {}
    try:
        t0 = time.perf_counter()
        opt = _phase_text_cnn_main()
        parts["a"] = round(time.perf_counter() - t0, 1)
        for part, run in (("b", _phase_text_cnn_news20_shape),
                          ("c", lambda: _phase_text_cnn_serving(opt)),
                          ("d", _phase_item14)):
            t0 = time.perf_counter()
            run()
            parts[part] = round(time.perf_counter() - t0, 1)
    finally:
        torch.backends.cudnn.deterministic = det
    if _model_launches() != kernels_before:
        raise AssertionError("phase 19 launched a kernel of csrc/")
    print(smi, flush=True)
    say(f"phase 19 took {time.perf_counter() - t_phase:.1f} s (seconds by "
        f"part {parts})")


# ---- phase 20: the flagship behind the router --------------------------
ROUTER_REPLICAS = ("r0", "r1", "r2")
ROUTER_SINGLE_LENS = [100, 400, 127, 260, 200, 350, 256, 130, 300, 120, 390,
                      250]
ROUTER_SESSION_LENS = [100, 150, 180, 120]
ROUTER_TURN_TOKENS = 16
ROUTER_AFFINITY_MIN = 8
# the canary's pinned prompts and their decode length (32 tokens: a
# single flipped near-tie reads 1/32, under the 0.05 threshold)
CANARY_PROMPTS = 4
CANARY_TOKENS = 32
ROLLOUT_PERTURB = 1e-6
PARTITION_TOL = 1e-6
ENGINE_HOPS = ("req.queue", "req.prefill", "req.preempt", "req.decode")
# trace id -> the engine e2e of the routed answer that carried it
_ENGINE_E2E = {}


def _router_post(front, prompt, session=None, n_new=SERVE_NEW_TOKENS):
    body = {"prompt": [int(t) for t in prompt], "max_new_tokens": n_new}
    if session is not None:
        body["session"] = session
    out = _http(front.url("/v1/generate"), body)
    if out[0] == 200 and out[2].get("trace"):
        _ENGINE_E2E[out[2]["trace"]] = out[2]["e2e_s"]
    return out


def _router_fleet():
    """Three replicas of the flagship (seed 0), each its own model (a
    swap must touch one replica only), started, behind a Router and a
    RouterServer."""
    from bigdl_tpu_torch.serving import EngineReplica, Router, RouterServer

    models = {n: _flagship(0) for n in ROUTER_REPLICAS}
    engines = {n: _lm_engine(models[n]).start() for n in ROUTER_REPLICAS}
    router = Router([EngineReplica(n, engines[n]) for n in ROUTER_REPLICAS],
                    request_timeout_s=120.0)
    return models, engines, router, RouterServer(router, port=0)


def _router_traffic(front) -> dict:
    """(a): 12 client threads, 24 requests: four threads run a session
    of three turns each (a turn's prompt is the last prompt, its answer
    and 16 new tokens), eight run the 12 single requests."""
    rs = np.random.RandomState(20)
    singles = [rs.randint(0, 8192, n) for n in ROUTER_SINGLE_LENS]
    firsts = [rs.randint(0, 8192, n) for n in ROUTER_SESSION_LENS]
    extra = [[rs.randint(0, 8192, ROUTER_TURN_TOKENS) for _ in range(2)]
             for _ in ROUTER_SESSION_LENS]

    def client(i):
        out = []
        if i < 4:
            prompt = list(firsts[i])
            for turn in range(3):
                ans = _router_post(front, prompt, session=f"s{i}")
                out.append((prompt, ans))
                if ans[0] != 200:
                    break
                if turn < 2:
                    prompt = prompt + ans[2]["tokens"] + list(
                        extra[i][turn])
            return out
        for k in ((i - 4, i + 4) if i < 8 else (i - 4,)):
            out.append((list(singles[k]), _router_post(front, singles[k])))
        return out

    t0 = time.perf_counter()
    results = [r for rs_ in _in_threads(client, 12) for r in rs_]
    wall = time.perf_counter() - t0
    return {"results": results, "wall": wall, "singles": singles}


def _check_router_answers(models, results, what: str) -> None:
    """Every answer 200 and whole, each token within 1e-3 of the top
    logit of the model of the replica that served it."""
    bad = [(a[0], a[2].get("error")) for _, a in results
           if a[0] != 200 or len(a[2]["tokens"]) != SERVE_NEW_TOKENS]
    if bad:
        raise AssertionError(f"phase 20 {what}: failed answers {bad}")
    worst = 0.0
    for name, model in models.items():
        mine = [(p, a[2]["tokens"]) for p, a in results
                if a[2]["replica"] == name]
        if mine:
            worst = max(worst, _top_logit_gap(
                model, [p for p, _ in mine], [t for _, t in mine]))
    say(f"phase 20 {what}: worst (top logit - served token's logit) "
        f"{worst:.3e} (limit 1e-3)")
    if worst > 1e-3:
        raise AssertionError(f"phase 20 {what}: a token off the top logit "
                             f"by {worst}")


def _phase_router_a(front, router, models, direct_tps: float) -> dict:
    from bigdl_tpu_torch.ops import _cuda

    _router_post(front, [1, 2, 3], n_new=2)                # warm
    torch.cuda.synchronize()
    hits0 = router.placement.affinity_hits
    _cuda.reset_launches()
    run = _router_traffic(front)
    torch.cuda.synchronize()
    launches = dict(_cuda.launches)
    results = run["results"]
    if len(results) != 24:
        raise AssertionError(f"phase 20 (a): {len(results)} answers of 24")
    _check_router_answers(models, results, "(a) routed")
    hits = router.placement.affinity_hits - hits0
    per = {n: sum(a[2]["replica"] == n for _, a in results)
           for n in ROUTER_REPLICAS}
    e2e = [a[3] for _, a in results]
    over = [a[3] - a[2]["e2e_s"] for _, a in results]
    tps = 24 * SERVE_NEW_TOKENS / run["wall"]
    say(f"phase 20 (a) 24 requests from 12 clients in {run['wall']:.3f} s: "
        f"per replica {per}; affinity hits {hits} (at least "
        f"{ROUTER_AFFINITY_MIN}); client e2e p50 {_pct(e2e, 50) * 1e3:.2f}"
        f" / p99 {_pct(e2e, 99) * 1e3:.2f} ms; router + HTTP a request "
        f"(client e2e - engine e2e) p50 {_pct(over, 50) * 1e3:.2f} / p99 "
        f"{_pct(over, 99) * 1e3:.2f} ms; {tps:.1f} tokens/s over three "
        f"replicas against phase 4's direct {direct_tps:.1f}; launches "
        f"{launches}")
    if hits < ROUTER_AFFINITY_MIN:
        raise AssertionError(f"phase 20 (a): {hits} affinity hits")
    if launches.get("flash_fwd", 0) <= 0 \
            or launches.get("paged_decode", 0) <= 0:
        raise AssertionError(f"phase 20 (a) launched {launches}")
    by_prompt = {tuple(int(t) for t in p): a[2]["tokens"]
                 for p, a in results}
    return {"results": results, "by_prompt": by_prompt,
            "singles": run["singles"]}


def _decode_totals(engines) -> dict:
    """(steps, decode ms, decode-thread CPU ms) summed, of each engine so
    far."""
    out = {}
    for n, e in engines.items():
        st = e.stats()
        out[n] = (st["steps"], (st["decode_ms_mean"] or 0.0) * st["steps"],
                  (st["decode_cpu_ms_mean"] or 0.0) * st["steps"])
    return out


def _step_split(before, after) -> dict:
    """Each engine's (decode step wall ms, its thread's CPU ms) a step
    between two ``_decode_totals``."""
    out = {}
    for n in after:
        steps = max(1, after[n][0] - before[n][0])
        out[n] = (round((after[n][1] - before[n][1]) / steps, 3),
                  round((after[n][2] - before[n][2]) / steps, 3))
    return out


def _device_busy_ms(prof) -> float:
    """The union of the device intervals (kernels, copies, on every
    stream) in a ``torch.profiler`` run, in ms."""
    from torch.autograd import DeviceType

    spans_ = sorted((e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.device_type == DeviceType.CUDA
                    and e.time_range.end > e.time_range.start)
    busy, end = 0.0, None
    for a, b in spans_:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3


def _router_controls(front, engines, singles) -> None:
    """(a) controls, for where (a)'s time goes: the 12 single prompts at
    once through the router over the three replicas, then once more
    under ``torch.profiler`` (device events only) for the device's busy
    share, and the same 12 straight into one engine, with each
    replica's decode step ms and its step thread's CPU ms (the rest of
    the step the thread waited: for the interpreter lock, the device or
    the OS)."""
    from torch.profiler import ProfilerActivity, profile

    def burst(tag, profiled=False):
        before = _decode_totals(engines)
        with (profile(activities=[ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            ans = _in_threads(lambda i: _router_post(front, singles[i]), 12)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if any(x[0] != 200 or len(x[2]["tokens"]) != SERVE_NEW_TOKENS
               for x in ans):
            raise AssertionError(f"phase 20 (a) {tag}: a request failed")
        split = _step_split(before, _decode_totals(engines))
        busy = ""
        if prof is not None:
            busy_ms = _device_busy_ms(prof)
            busy = (f"; device busy {busy_ms:.1f} ms of {wall * 1e3:.1f}, "
                    f"share {busy_ms / (wall * 1e3):.3f}" if busy_ms > 0
                    else "; the profiler shows no device time (busy share "
                    "not measured)")
        say(f"phase 20 (a) control, {tag}: 12 requests in {wall:.3f} s, "
            f"{12 * SERVE_NEW_TOKENS / wall:.1f} tokens/s; decode step "
            f"(wall ms, thread CPU ms) by replica {split}{busy}")

    burst("router over 3 replicas, switch interval "
          f"{sys.getswitchinterval() * 1e3:g} ms")
    burst("router over 3 replicas, profiled", profiled=True)
    eng = engines["r1"]
    before = _decode_totals({"r1": eng})
    t0 = time.perf_counter()
    reqs = [eng.submit(p, SERVE_NEW_TOKENS) for p in singles]
    for r in reqs:
        r.wait(600)
    wall = time.perf_counter() - t0
    split = _step_split(before, _decode_totals({"r1": eng}))["r1"]
    if any(r.error or len(r.tokens) != SERVE_NEW_TOKENS for r in reqs):
        raise AssertionError("phase 20 (a) control: a direct request failed")
    say(f"phase 20 (a) control, the 12 straight into r1 (no HTTP, the "
        f"other replicas idle): {wall:.3f} s, "
        f"{12 * SERVE_NEW_TOKENS / wall:.1f} tokens/s; decode step "
        f"{split[0]:.3f} ms wall, {split[1]:.3f} ms thread CPU")


def _router_fused(models, engines, singles) -> None:
    """(a) with ``decode_attn="fused"``: one engine over r0's model
    behind a router and a RouterServer of its own, the 12 single prompts
    at once; every token held to r0's top logit (1e-3), the paged
    decode kernel launched no time; its decode step and analytic bytes
    a token beside r0's (the kernel's)."""
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.serving import EngineReplica, Router, RouterServer

    r0_bytes = engines["r0"].stats()["decode_hbm_bytes_per_token"]
    eng = _lm_engine(models["r0"], decode_attn="fused").start()
    front = RouterServer(Router([EngineReplica("fused", eng)],
                                request_timeout_s=120.0), port=0)
    try:
        _router_post(front, [1, 2, 3], n_new=2)            # warm
        torch.cuda.synchronize()
        before = _decode_totals({"fused": eng})
        _cuda.reset_launches()
        t0 = time.perf_counter()
        ans = _in_threads(lambda i: _router_post(front, singles[i]), 12)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.launches)
        split = _step_split(before, _decode_totals({"fused": eng}))["fused"]
        st = eng.stats()
    finally:
        front.close()
        eng.close()
    _check_router_answers({"fused": models["r0"]},
                          list(zip(singles, ans)), "(a) fused decode")
    say(f"phase 20 (a) decode_attn=\"fused\", one replica: 12 requests in "
        f"{wall:.3f} s, {12 * SERVE_NEW_TOKENS / wall:.1f} tokens/s; decode "
        f"step {split[0]:.3f} ms wall, {split[1]:.3f} ms thread CPU; "
        f"analytic bytes a token {st['decode_hbm_bytes_per_token']:.4g} "
        f"(r0's kernel decode: {r0_bytes:.4g}); "
        f"launches {launches}")
    if launches.get("paged_decode", 0) or launches.get("flash_fwd", 0) <= 0:
        raise AssertionError(f"phase 20 (a) fused launched {launches}")


def _phase_router_b(front, router, engines, models, a) -> None:
    """(b): bind a session, put four of (a)'s single prompts on it at
    once, drain its replica at deadline 0 while they decode."""
    import threading

    from bigdl_tpu_torch.obs import names

    prompts = a["singles"][:4]
    first = _router_post(front, prompts[0], session="drain", n_new=2)
    if first[0] != 200:
        raise AssertionError(f"phase 20 (b): bind answered {first}")
    bound = first[2]["replica"]
    eng = engines[bound]
    ledger0 = router.ledger.stats()
    handoffs0 = _counter_value(names.ROUTER_HANDOFFS_TOTAL)
    start = eng.stats()["tokens"]
    out, drained = {}, {}

    def clients():
        out["answers"] = _in_threads(lambda i: _router_post(
            front, prompts[i], session="drain"), len(prompts))

    t = threading.Thread(target=clients, daemon=True)
    t.start()
    deadline = time.monotonic() + 300
    while True:
        with eng.locked():
            held = eng.queue.depth() + eng.active_count() + len(eng._stash)
            decoded = eng.stats()["tokens"] - start
        if held == len(prompts) and decoded >= 2 * DRAIN_AFTER_TOKENS:
            break
        if time.monotonic() > deadline or not t.is_alive():
            raise AssertionError("phase 20 (b): the requests never decoded "
                                 "on the bound replica")
        time.sleep(0.002)
    t0 = time.perf_counter()
    drained["summary"] = router.begin_drain(bound, deadline_s=0.0)
    drain_ms = (time.perf_counter() - t0) * 1e3
    t.join(timeout=600)
    answers = out.get("answers") or []
    router.undrain(bound)
    summary = drained["summary"]
    ledger = router.ledger.stats()
    results = list(zip([list(p) for p in prompts], answers))
    _check_router_answers(models, results, "(b) drained + replayed")
    n_hand = sum(a[2]["handoffs"] for _, a in results)
    equal = sum(a[2]["tokens"] == a_tok for (_, a), a_tok in zip(
        results, (a["by_prompt"][tuple(int(t) for t in p)]
                  for p in prompts)))
    claims = ledger["claimed"] - ledger0["claimed"]
    say(f"phase 20 (b) drain of {bound} at deadline 0 after "
        f"{2 * DRAIN_AFTER_TOKENS} tokens took {drain_ms:.1f} ms: "
        f"{summary['handoffs']} handoffs ({summary['router_owned']} "
        f"router-owned), replayed on {sorted({a[2]['replica'] for _, a in results})}; "
        f"claims {claims}, ledger {ledger}; answers equal to (a)'s "
        f"{equal}/{len(prompts)}")
    if (summary["handoffs"] == 0 or summary["router_owned"]
            != summary["handoffs"] or n_hand != summary["handoffs"]
            or claims != summary["handoffs"] or ledger["duplicates"]
            or _counter_value(names.ROUTER_HANDOFFS_TOTAL) - handoffs0
            != summary["handoffs"]):
        raise AssertionError(f"phase 20 (b): handoffs {summary}, replayed "
                             f"{n_hand}, claims {claims}, ledger {ledger}")
    if equal != len(prompts):
        raise AssertionError("phase 20 (b): a replayed stream differs from "
                             "the undrained run's")


def _counter_value(name, **labels) -> float:
    from bigdl_tpu_torch import obs

    for fam in obs.get_registry().families():
        if fam.name == name:
            return sum(c.value for key, c in fam.child_items()
                       if all(dict(zip(fam.labelnames, key)).get(k) == v
                              for k, v in labels.items()))
    return 0.0


def _wait_idle(engines) -> None:
    deadline = time.monotonic() + 300
    while any(e.queue.depth() or e.active_count() or e._stash
              for e in engines.values()):
        if time.monotonic() > deadline:
            raise AssertionError("phase 20: a replica never went idle")
        time.sleep(0.005)


def _phase_router_c(front, router, engines, models, a) -> None:
    """(c): r0's queue closed: six requests retry onto r1/r2 within the
    budget.  Then a budget of 0 with r1's and r2's loops held (their
    queues fill, nothing is served): six more are shed 503."""
    import contextlib as _ctx

    from bigdl_tpu_torch.obs import names
    from bigdl_tpu_torch.resilience import RetryBudget

    retries0 = _counter_value(names.ROUTER_RETRIES_TOTAL)
    shed0 = _counter_value(names.ROUTER_SHED_TOTAL)
    prompts = a["singles"][4:10]
    engines["r0"].queue.close()
    first = _in_threads(lambda i: _router_post(front, prompts[i]), 6)
    results = list(zip([list(p) for p in prompts], first))
    _check_router_answers(models, results, "(c) retried")
    seen_retries = sum(ans[2]["retries"] for ans in first)
    saved_budget, saved_timeout = router.budget, router.request_timeout_s
    router.budget = RetryBudget(ratio=0.0, burst=0.0)
    router.request_timeout_s = 0.5
    with _ctx.ExitStack() as held:
        for n in ("r1", "r2"):
            held.enter_context(engines[n].locked())
        shed = _in_threads(lambda i: _router_post(front, prompts[i]), 6)
    router.budget, router.request_timeout_s = saved_budget, saved_timeout
    n_shed = sum(s[0] == 503 for s in shed)
    retry_after = {s[1].get("Retry-After") for s in shed}
    d_retries = _counter_value(names.ROUTER_RETRIES_TOTAL) - retries0
    d_shed = _counter_value(names.ROUTER_SHED_TOTAL) - shed0
    say(f"phase 20 (c) r0's queue closed: 6 answered on "
        f"{sorted({s[2]['replica'] for s in first})} after {seen_retries} "
        f"retries (budget {saved_budget.stats()}); budget 0 and r1, r2 "
        f"held: {n_shed}/6 shed 503, Retry-After {retry_after}; counters: "
        f"retries +{d_retries:g}, shed +{d_shed:g}")
    if seen_retries < 1 or any(s[2]["replica"] == "r0" for s in first):
        raise AssertionError("phase 20 (c): no retry off the closed queue")
    if n_shed != 6 or retry_after != {"1"}:
        raise AssertionError(f"phase 20 (c): shed answers {shed}")
    if d_retries != seen_retries or d_shed != n_shed:
        raise AssertionError(f"phase 20 (c): counters retries {d_retries} "
                             f"shed {d_shed} against the clients' "
                             f"{seen_retries} and {n_shed}")
    # the shed requests queued on r1/r2 finish with nobody waiting; r0
    # comes back as a new engine on its weights
    _wait_idle({n: engines[n] for n in ("r1", "r2")})
    from bigdl_tpu_torch.serving import EngineReplica

    engines["r0"].close()
    engines["r0"] = _lm_engine(models["r0"]).start()
    router.remove_replica("r0")
    router.add_replica(EngineReplica("r0", engines["r0"]))


def _perturbed(seed: int, scale: float):
    model = _flagship(0)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(scale * torch.randn(p.shape, generator=gen, device=DEV))
    return model


def _phase_router_d(front, router, engines, models, a, tmp: str) -> None:
    """(d): the rollout: v1 promoted, v2 refused, v3 rolled back."""
    import threading

    from bigdl_tpu_torch.obs import names
    from bigdl_tpu_torch.serving import (CanaryController,
                                         CheckpointWatcher,
                                         publish_checkpoint)
    from bigdl_tpu_torch.serving.rollout import divergence_probe

    watch = os.path.join(tmp, "watch")
    watchers = {n: CheckpointWatcher(engines[n], watch)
                for n in ROUTER_REPLICAS}
    trees = {"v0": _host_tree(models["r0"].params())}
    swap_ms, poll_ms = [], []
    for n, eng in engines.items():
        def timed(params, *, version, manifest_sha=None, _orig=eng.swap_weights):
            t0 = time.perf_counter()
            _orig(params, version=version, manifest_sha=manifest_sha)
            swap_ms.append((time.perf_counter() - t0) * 1e3)
        eng.swap_weights = timed

    def set_version(name, version):
        eng = engines[name]
        if eng.weight_version == version:
            return
        if version in trees:
            eng.swap_weights(trees[version], version=version)
            return
        t0 = time.perf_counter()
        watchers[name].poll_once()
        poll_ms.append((time.perf_counter() - t0) * 1e3)
        if eng.weight_version != version:
            raise AssertionError(f"phase 20 (d): {name} serves "
                                 f"{eng.weight_version}, not {version}")

    pinned = a["singles"][:CANARY_PROMPTS]
    probe = divergence_probe(
        lambda p, n: router.replicas["r0"].generate(p, n)["tokens"],
        lambda p, n: router.replicas["r1"].generate(p, n)["tokens"],
        [[int(t) for t in p[:64]] for p in pinned], CANARY_TOKENS)
    divs = []

    def measure():
        divs.append(probe())
        return divs[-1]

    ctl = CanaryController(
        list(ROUTER_REPLICAS), set_version=set_version, incumbent="v0",
        measure_divergence=measure, alerts=lambda: [],
        drain=lambda n: router.begin_drain(n, deadline_s=60.0),
        undrain=router.undrain, fraction=0.34, for_count=2, hold_evals=2,
        cooldown_s=30.0)
    # v1: a perturbed flagship, promoted
    v1 = _perturbed(7, ROLLOUT_PERTURB)
    publish_checkpoint(v1, watch, "v1")
    if not ctl.offer("v1") or ctl.canaries != ["r0"]:
        raise AssertionError(f"phase 20 (d): offer of v1 {ctl.stats()}")
    for _ in range(2):
        ctl.evaluate()
    versions = {n: e.weight_version for n, e in engines.items()}
    say(f"phase 20 (d) v1 (seed 0 + {ROLLOUT_PERTURB:g} N(0,1)): canary "
        f"r0, divergence {divs}, then {ctl.state}, incumbent "
        f"{ctl.incumbent}, versions {versions}")
    if ctl.promotions != ["v1"] or set(versions.values()) != {"v1"} \
            or len(poll_ms) != 3:
        raise AssertionError(f"phase 20 (d): v1 not promoted through the "
                             f"watchers {ctl.stats()}, {len(poll_ms)} polls")
    # the incumbent's weights on the host, for a rollback's revert
    trees["v1"] = _host_tree(v1.params())
    # v2: one byte flipped after the manifest, refused
    del v1
    prefix = publish_checkpoint(_flagship(2), watch, "v2")
    with open(prefix + ".model.npz", "r+b") as fh:
        fh.seek(4096)
        byte = fh.read(1)
        fh.seek(4096)
        fh.write(bytes([byte[0] ^ 0x01]))
    swaps0 = engines["r0"].swaps
    rejected0 = _counter_value(names.ROLLOUT_REJECTED_TOTAL,
                               reason="checksum")
    if watchers["r0"].poll_once() is not None:
        raise AssertionError("phase 20 (d): the corrupted v2 was loaded")
    reason = watchers["r0"].rejected.get(prefix, "")
    say(f"phase 20 (d) v2 with a flipped byte: refused ({reason}); r0 "
        f"serves {engines['r0'].weight_version}")
    if ("checksum" not in reason or engines["r0"].swaps != swaps0
            or engines["r0"].weight_version != "v1"
            or _counter_value(names.ROLLOUT_REJECTED_TOTAL,
                              reason="checksum") != rejected0 + 1):
        raise AssertionError("phase 20 (d): v2 not refused and counted")
    # v3: other weights, rolled back while clients send
    publish_checkpoint(_flagship(1), watch, "v3")
    if not ctl.offer("v3"):
        raise AssertionError(f"phase 20 (d): offer of v3 {ctl.stats()}")
    ctl.evaluate()
    out = {}
    clients = threading.Thread(target=lambda: out.update(a=_in_threads(
        lambda i: _router_post(front, a["singles"][i]), 8)), daemon=True)
    clients.start()
    decision = ctl.evaluate()
    clients.join(timeout=600)
    answers = out.get("a") or []
    dropped = [x[0] for x in answers if x[0] != 200
               or len(x[2]["tokens"]) != SERVE_NEW_TOKENS]
    versions = {n: e.weight_version for n, e in engines.items()}
    cooled = not ctl.offer("v3")
    say(f"phase 20 (d) v3 (seed 1): divergence {divs[-2:]}, "
        f"{decision.get('state')} ({decision.get('rollback')}); versions "
        f"after {versions}; {len(answers)} requests during the rollback, "
        f"dropped {len(dropped)}; an offer inside the cooldown refused "
        f"{cooled}; swaps {len(swap_ms)}: "
        f"{[round(x, 1) for x in swap_ms]} ms; poll-to-swap (verify, load "
        f"on the host, swap) {[round(x, 1) for x in poll_ms]} ms")
    if (decision.get("rollback") != "divergence" or len(ctl.rollbacks) != 1
            or set(versions.values()) != {"v1"} or len(answers) != 8
            or dropped or not cooled):
        raise AssertionError(f"phase 20 (d): rollback {decision}, "
                             f"{ctl.stats()}, versions {versions}, "
                             f"dropped {dropped}")
    for eng in engines.values():
        del eng.swap_weights


def _phase_router_e(a) -> None:
    """(e): the exact partition of every kept trace, the obs server, and
    strict mode."""
    import urllib.request

    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs import metrics, reqtrace, server

    col = reqtrace.get_collector()
    worst, checked = 0.0, 0
    for entry in col.completed():
        hops = [s for s in entry["spans"] if s["name"] in ENGINE_HOPS]
        if not hops:
            continue
        # a routed trace's entry ends with the router's e2e; the engine's
        # rode its answer
        e2e = _ENGINE_E2E.get(entry["trace"], entry["e2e_s"])
        worst = max(worst, abs(sum(s["dur_s"] for s in hops) - e2e))
        checked += 1
    srv = server.ensure_server()
    rid = a["results"][0][1][2]["id"]
    code, _, kept, _ = _http(srv.url(f"/trace?request={rid}"))
    t0 = time.perf_counter()
    with urllib.request.urlopen(srv.url("/metrics"), timeout=60) as r:
        text = r.read().decode()
    scrape_ms = (time.perf_counter() - t0) * 1e3
    parsed = metrics.parse_prometheus(text)
    fams = set(parsed["families"])
    exemplars = sum("exemplar" in smp for smp in parsed["samples"])
    os.environ["BIGDL_TORCH_OBS_STRICT"] = "1"
    try:
        obs.get_registry().counter("bigdl_phase20_undeclared_total")
        refused = False
    except ValueError:
        refused = True
    finally:
        os.environ.pop("BIGDL_TORCH_OBS_STRICT", None)
    stats = col.stats()
    say(f"phase 20 (e) {checked} kept traces with engine hops: worst |queue "
        f"+ prefill + preempt + decode - engine e2e| {worst:.3e} s (limit "
        f"{PARTITION_TOL:g}); sampler {stats}; /trace?request={rid} "
        f"{code} with {len(kept.get('spans', []))} spans; /metrics "
        f"{len(text)} bytes, {len(parsed['samples'])} samples, "
        f"{exemplars} exemplars, scraped in {scrape_ms:.2f} ms; strict "
        f"mode refused an undeclared bigdl_ family: {refused}")
    if checked < 24 or worst > PARTITION_TOL:
        raise AssertionError(f"phase 20 (e): partition {worst} over "
                             f"{checked} traces")
    if code != 200 or kept.get("request") != rid or not any(
            s["name"] == "req.route" for s in kept["spans"]):
        raise AssertionError(f"phase 20 (e): /trace?request={rid}: {kept}")
    for prefix in ("bigdl_router_", "bigdl_rollout_", "bigdl_serve_"):
        if not any(f.startswith(prefix) for f in fams):
            raise AssertionError(f"phase 20 (e): /metrics lacks {prefix}*")
    if exemplars < 1 or not refused:
        raise AssertionError("phase 20 (e): no exemplar, or strict mode "
                             "let an undeclared family in")


def phase_router(smi: str, direct_tps: float) -> None:
    """Phase 20: three flagship replicas behind the router, with drain,
    retry and shed, rollout, traces and metrics."""
    import tempfile

    from bigdl_tpu_torch import obs

    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in ("BIGDL_TORCH_REQTRACE_SAMPLE",
                                            "BIGDL_TORCH_OBS_PORT")}
    os.environ["BIGDL_TORCH_REQTRACE_SAMPLE"] = "1"
    os.environ["BIGDL_TORCH_OBS_PORT"] = "0"
    obs.reset()
    _ENGINE_E2E.clear()
    models, engines, router, front = _router_fleet()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            a = _phase_router_a(front, router, models, direct_tps)
            _router_controls(front, engines, a["singles"])
            _router_fused(models, engines, a["singles"])
            _phase_router_b(front, router, engines, models, a)
            _phase_router_c(front, router, engines, models, a)
            _phase_router_d(front, router, engines, models, a, tmp)
            _wait_idle(engines)
            _phase_router_e(a)
    finally:
        front.close()
        for eng in engines.values():
            eng.close()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        obs.reset()
    del models
    torch.cuda.empty_cache()
    print(smi, flush=True)
    say(f"phase 20 took {time.perf_counter() - t_phase:.1f} s")


# ---- phase 21: ImageFrame -> fused ResNet-50 -> background checkpoints ----
def _p21_decode(root: str):
    """Phase 15's folder decoded by ``read_image``: (train arrays, train
    labels, val arrays, val labels, decode ms a batch of IMG_BATCH)."""
    from bigdl_tpu_torch.dataset.imagenet import scan_image_folder
    from bigdl_tpu_torch.transform.vision import read_image

    out, n = [], 0
    t0 = time.perf_counter()
    for split in ("train", "val"):
        paths, labels, _ = scan_image_folder(os.path.join(root, split))
        out += [[read_image(p) for p in paths], [float(v) for v in labels]]
        n += len(paths)
    return (*out, (time.perf_counter() - t0) * 1e3 / n * IMG_BATCH)


def _p21_norm(V):
    from bigdl_tpu_torch.dataset.imagenet import ImageFolderDataSet as F

    return V.ChannelNormalize(*F.IMAGENET_MEAN, *F.IMAGENET_STD)


def _p21_train_chain(V):
    """The reference's ImageNet training augmentation."""
    return (V.RandomAspectScale([256, 288]) >> V.RandomCrop(IMG_SIZE, IMG_SIZE)
            >> V.RandomTransformer(V.HFlip(), 0.5) >> V.ColorJitter()
            >> _p21_norm(V) >> V.MatToTensor())


def _p21_val_chain(V):
    return (V.Resize(256, 256) >> V.CenterCrop(IMG_SIZE, IMG_SIZE)
            >> _p21_norm(V) >> V.MatToTensor())


def _p21_resnet(fused: bool = True):
    """ResNet-50 with 8 classes from seed 0, fused or not, the
    LogSoftMax tail dropped for ``CrossEntropyCriterion`` as in phase 7
    (a bf16 LogSoftMax rounds each log-probability to a bf16 ulp, some
    8e-3 at a loss of 2, which phase 7's 1e-2 limit would read)."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.resnet import build_resnet_imagenet
    from bigdl_tpu_torch.nn.fused import fuse_conv_bn

    RandomGenerator.RNG.set_seed(0)
    model = build_resnet_imagenet(50, IMG_CLASSES, device=DEV)
    if fused:
        fuse_conv_bn(model, kernels=(1, 3))
    model.modules = model.modules[:-1]
    return model


def _p21_trainer(model, ds, summary=None, end=None, ck=None,
                 background=True, every=None, keep_last=0):
    """``DistriOptimizer`` at world 1 (bf16 compute, bf16 wire) with
    SGD and momentum; checkpoints into ``ck`` every ``every``
    (default ``P21_CKPT_EVERY``) iterations."""
    from bigdl_tpu_torch.nn import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger

    opt = DistriOptimizer(model, ds, CrossEntropyCriterion(), IMG_BATCH,
                          device=DEV)
    opt.set_optim_method(SGD(learningrate=P21_LR, momentum=0.9))
    opt.set_compute_dtype("bfloat16")
    opt.set_end_when(end or Trigger.max_epoch(P21_EPOCHS))
    if ck:
        opt.set_checkpoint(ck, Trigger.several_iteration(
            every or P21_CKPT_EVERY),
                           background=background, keep_last=keep_last)
    if summary is not None:
        opt.set_train_summary(summary)
    return opt


def _p21_recording_summary(log_dir: str):
    """A ``TrainSummary`` that also keeps each step's loss as the
    trainer handed it, and the host clock when it did."""
    from bigdl_tpu_torch.visualization import TrainSummary

    class Recording(TrainSummary):
        def __init__(self):
            super().__init__(log_dir, "resnet50")
            self.loss, self.at = {}, {}

        def add_scalar(self, tag, value, step):
            if tag == "Loss":
                self.loss[step] = value
                self.at[step] = time.perf_counter()
            return super().add_scalar(tag, value, step)

    return Recording()


@contextlib.contextmanager
def _p21_verified_writes(log: list):
    """Every checkpoint write verified against its manifest as it lands
    (on the writer's thread), before retention may delete it."""
    from bigdl_tpu_torch.utils import serializer as S

    real = S.write_checkpoint

    def checked(snap, prefix, keep_last=0, background=False):
        out = real(snap, prefix, keep_last, background)
        log.append((os.path.basename(prefix), S.verify_checkpoint(prefix)))
        return out

    S.write_checkpoint = checked
    try:
        yield log
    finally:
        S.write_checkpoint = real


def _p21_host(model) -> list:
    from bigdl_tpu_torch.utils import tree as T

    return [v.detach().cpu().clone()
            for v in T.leaves(model.params()) + T.leaves(model.state())]


def _p21_fires(every: int, steps: int) -> int:
    """How often a several-iteration trigger asked before each step's
    neval moves (the "Parameters" trigger) fires in ``steps`` steps."""
    return sum(1 for n in range(1, steps + 1) if n > 1 and (n - 1) % every == 0)


def _phase21_main(root: str, tmp: str, smi: str):
    """(a): the frame, the unfused first step, the fused run and its
    gates.  Returns (optimizer, model, train dataset, val frame)."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.optim import Top1Accuracy, Trigger
    from bigdl_tpu_torch.transform import vision as V
    from bigdl_tpu_torch.utils import serializer as S
    from bigdl_tpu_torch.utils import tree as T
    from bigdl_tpu_torch.visualization import ValidationSummary

    tr_x, tr_y, va_x, va_y, decode_ms = _p21_decode(root)
    RandomGenerator.RNG.set_seed(0)
    t0 = time.perf_counter()
    frame = V.DistributedImageFrame.read(tr_x, tr_y)
    ds = frame.transform(_p21_train_chain(V)).to_dataset(IMG_BATCH)
    transform_ms = (time.perf_counter() - t0) * 1e3 / (len(tr_x) / IMG_BATCH)
    val_frame = V.ImageFrame.read(va_x, va_y).transform(_p21_val_chain(V))
    val_ds = val_frame.to_dataset(IMG_BATCH)
    del tr_x, va_x, frame
    steps = P21_EPOCHS * len(ds.labels) // IMG_BATCH

    # the unfused arm's first loss on the same first batch
    std = _p21_resnet(False)
    first = _Losses()
    opt = _p21_trainer(std, ds, first, Trigger.max_iteration(1))
    RandomGenerator.RNG.set_seed(1)
    opt.optimize()
    std_first = first.loss[1]
    del opt, std
    torch.cuda.empty_cache()

    model = _p21_resnet(True)
    summary = _p21_recording_summary(os.path.join(tmp, "tb"))
    summary.set_summary_trigger("Parameters",
                                Trigger.several_iteration(P21_PARAM_EVERY))
    val_summary = ValidationSummary(os.path.join(tmp, "tb"), "resnet50")
    ck = os.path.join(tmp, "ck_a")
    opt = _p21_trainer(model, ds, summary, ck=ck, keep_last=P21_KEEP)
    opt.set_val_summary(val_summary)
    opt.set_validation(Trigger.every_epoch(), val_ds, [Top1Accuracy()])
    written = []
    with _p21_verified_writes(written):
        RandomGenerator.RNG.set_seed(1)
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = dict(_cuda.launches)
    loss = [summary.loss[n] for n in sorted(summary.loss)]
    step_ms = steady_step_ms(summary.at, steps // P21_EPOCHS)
    say(f"phase 21 (a) DistributedImageFrame (world {opt.n_shards}, "
        f"{len(ds.labels)} train + {len(val_frame)} val images) -> "
        f"fused ResNet-50, bf16, DistriOptimizer on "
        f"{opt.wire_dtype} wire: {len(loss)} losses "
        f"{['%.4f' % v for v in loss]}; first loss fused {loss[0]:.6f}, "
        f"unfused {std_first:.6f}, |gap| {abs(loss[0] - std_first):.3e} "
        f"(limit {LOSS_TOL:g}); conv_bn launches {launches['conv_bn_1x1']} "
        f"1x1, {launches['conv_bn_kxk']} kxk in {steps} steps; {secs:.1f} s")
    if len(loss) != steps or not all(np.isfinite(loss)):
        raise AssertionError("phase 21 (a): missing or non-finite losses")
    if not abs(loss[0] - std_first) <= LOSS_TOL:
        raise AssertionError("phase 21 (a): fused first loss off the "
                             "unfused one")
    got = (launches["conv_bn_1x1"], launches["conv_bn_kxk"])
    if got != (36 * steps, 16 * steps):
        raise AssertionError(f"phase 21 (a): conv_bn launches {got}, want "
                             f"{(36 * steps, 16 * steps)}")
    want_ckpts = steps // P21_CKPT_EVERY + P21_EPOCHS
    bad = [(n, r) for n, (ok, r) in written if not ok]
    kept = S.checkpoint_prefixes(ck)
    say(f"phase 21 (a) checkpoints: {len(written)} background writes "
        f"{[n for n, _ in written]}, each verified against its sha256 "
        f"manifest as it landed ({len(bad)} failed); {len(kept)} kept "
        f"(keep_last {P21_KEEP})")
    if len(written) != want_ckpts or bad or len(kept) != P21_KEEP:
        raise AssertionError(f"phase 21 (a): checkpoints {written}, kept "
                             f"{kept}")
    back = summary.read_scalar("Loss")
    exact = [s for s, v in back
             if np.float32(v).tobytes() == np.float32(summary.loss[s]).tobytes()]
    leaves = [("/".join(p), v) for p, v in T.leaves_with_paths(model.params())]
    fires = _p21_fires(P21_PARAM_EVERY, steps)
    hist = {tag: len(summary.read_histogram(tag)) for tag, _ in leaves}
    tops = val_summary.read_scalar("Top1Accuracy")
    say(f"phase 21 (a) TensorBoard: {len(exact)} of {len(back)} Loss "
        f"scalars read back equal to the step's f32 loss bit for bit; "
        f"{len(leaves)} parameter leaves, histograms each "
        f"{sorted(set(hist.values()))} (want {fires}); validation Top1 "
        f"{[(s, round(v, 4)) for s, v in tops]}")
    if sorted(exact) != sorted(summary.loss) or len(back) != steps:
        raise AssertionError("phase 21 (a): Loss scalars off the losses")
    if set(hist.values()) != {fires}:
        raise AssertionError(f"phase 21 (a): histograms {hist}")
    if len(tops) != P21_EPOCHS:
        raise AssertionError(f"phase 21 (a): validation {tops}")
    summary.close()
    val_summary.close()
    say(f"phase 21 (a) speed: step {step_ms:.3f} ms (median wall gap), "
        f"{IMG_BATCH / step_ms * 1e3:.1f} images/s; host decode "
        f"{decode_ms:.1f} ms and host transform {transform_ms:.1f} ms a "
        f"batch of {IMG_BATCH} (phase 15 decodes in its feed thread) "
        f"[{smi}]")
    return opt, model, ds, val_frame


def _p21_spans(names) -> dict:
    """The tracer's recent spans of each name, ms."""
    from bigdl_tpu_torch import obs

    out = {n: [] for n in names}
    for r in obs.get_tracer().recent():
        if r.get("kind") == "span" and r["name"] in out:
            out[r["name"]].append(r["dur_s"] * 1e3)
    return out


def _p21_short_run(ds, ck, background, tmp, tag):
    """(b): one epoch of (a)'s training, checkpoints every
    P21_CKPT_EVERY; returns (host weights and state, the timed losses,
    the checkpoint spans)."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.optim import Trigger

    os.environ["BIGDL_TORCH_TRACE_DIR"] = os.path.join(tmp, f"trace_{tag}")
    obs.reset()
    try:
        model = _p21_resnet(True)
        rec = _TimedLosses()
        opt = _p21_trainer(model, ds, rec, Trigger.max_iteration(
            P21_SHORT_STEPS), ck=ck, background=background)
        RandomGenerator.RNG.set_seed(1)
        opt.optimize()
        torch.cuda.synchronize()
        spans = _p21_spans(("checkpoint.snapshot", "checkpoint.write",
                            "checkpoint.write_async"))
    finally:
        os.environ.pop("BIGDL_TORCH_TRACE_DIR", None)
        obs.reset()
    out = (_p21_host(model), rec, spans)
    del opt, model
    torch.cuda.empty_cache()
    return out


def _p21_arrays(directory: str) -> dict:
    from bigdl_tpu_torch.utils import serializer as S

    out = {}
    for name in S.checkpoint_prefixes(directory):
        for suffix in (".model.npz", ".optim.npz"):
            with np.load(os.path.join(directory, name + suffix)) as d:
                out.update({(name, suffix, k): np.array(d[k])
                            for k in d.files})
    return out


def _phase21_background(ds, tmp: str, smi: str) -> None:
    """(b): background against synchronous writes, then a write that
    fails under the writer."""
    import shutil

    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.obs import names
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.resilience.retry import CheckpointWriteError
    from bigdl_tpu_torch.utils import serializer as S

    bg = _p21_short_run(ds, os.path.join(tmp, "ck_bg"), True, tmp, "bg")
    sync = _p21_short_run(ds, os.path.join(tmp, "ck_sync"), False, tmp,
                          "sync")
    same_w = all(torch.equal(a, b) for a, b in zip(bg[0], sync[0]))
    a, b = _p21_arrays(os.path.join(tmp, "ck_bg")), _p21_arrays(
        os.path.join(tmp, "ck_sync"))
    same_ck = sorted(a) == sorted(b) and all(
        np.array_equal(a[k], b[k]) for k in a)
    n_ck = len({k[0] for k in a})
    ck_steps = {n + 1 for n in range(1, P21_SHORT_STEPS + 1)
                if n % P21_CKPT_EVERY == 0}

    def gaps(rec, at_ck):
        at = rec.at
        return [(at[n] - at[n - 1]) * 1e3 for n in sorted(at)
                if n - 1 in at and n > 2 and (n in ck_steps) == at_ck]

    say(f"phase 21 (b) background vs synchronous writes, cuDNN "
        f"deterministic, {P21_SHORT_STEPS} steps: final weights and BN "
        f"state bit-equal {same_w}; {n_ck} checkpoints, every array of "
        f"each bit-equal {same_ck}; blocking checkpoint.snapshot "
        f"{['%.1f' % v for v in bg[2]['checkpoint.snapshot']]} ms, "
        f"checkpoint.write_async (writer thread) "
        f"{['%.1f' % v for v in bg[2]['checkpoint.write_async']]} ms; "
        f"synchronous snapshot "
        f"{['%.1f' % v for v in sync[2]['checkpoint.snapshot']]} + "
        f"checkpoint.write {['%.1f' % v for v in sync[2]['checkpoint.write']]}"
        f" ms; step ms after a checkpoint: background "
        f"{['%.1f' % v for v in gaps(bg[1], True)]}, synchronous "
        f"{['%.1f' % v for v in gaps(sync[1], True)]}; other steps median "
        f"{np.median(gaps(bg[1], False)):.1f} / "
        f"{np.median(gaps(sync[1], False)):.1f} ms [{smi}]")
    if not same_w or not same_ck or n_ck < 2:
        raise AssertionError("phase 21 (b): background and synchronous "
                             "writes differ")
    if not bg[2]["checkpoint.write_async"] or bg[2]["checkpoint.write"]:
        raise AssertionError(f"phase 21 (b): spans {bg[2]}")

    # a write that fails: the directory goes away under the writer
    obs.reset()
    ck = os.path.join(tmp, "ck_fail")
    real = S.write_checkpoint
    calls = []

    def vanishing(snap, prefix, keep_last=0, background=False):
        calls.append(prefix)
        if len(calls) == 2:
            shutil.rmtree(ck)
        return real(snap, prefix, keep_last, background)

    model = _p21_resnet(True)
    opt = _p21_trainer(model, ds, end=Trigger.max_iteration(P21_SHORT_STEPS),
                       ck=ck, every=P21_FAULT_CKPT_EVERY)
    S.write_checkpoint = vanishing
    raised = None
    try:
        RandomGenerator.RNG.set_seed(1)
        opt.optimize()
    except CheckpointWriteError as e:
        raised = e
    finally:
        S.write_checkpoint = real
    fam = {f.name: f for f in obs.get_registry().families()}.get(
        names.CHECKPOINT_WRITE_FAILURES_TOTAL)
    failures = fam.child_items()[0][1].value if fam else 0
    say(f"phase 21 (b) the checkpoint directory removed under the second "
        f"background write: {type(raised).__name__} at neval "
        f"{opt.state['neval']} ({raised!r:.120}); "
        f"{names.CHECKPOINT_WRITE_FAILURES_TOTAL} {failures:g}; "
        f"{len(calls)} writes started")
    if raised is None or failures != 1 or len(calls) != 2 \
            or opt.state["neval"] != 1 + 3 * P21_FAULT_CKPT_EVERY:
        raise AssertionError("phase 21 (b): the failed write did not "
                             "surface at the next trigger")
    obs.reset()
    del opt, model
    torch.cuda.empty_cache()


def _phase21_faults(ds, tmp: str) -> None:
    """(c): the fault plan against an uninterrupted run, then a NaN
    step."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.optim import Trigger
    from bigdl_tpu_torch.resilience.faults import reset_injector
    from bigdl_tpu_torch.utils import serializer as S

    loaded, verified = [], []
    real_load, real_verify = S.load_checkpoint, S.verify_checkpoint

    def recording_load(prefix, *a, **k):
        loaded.append(os.path.basename(prefix))
        return real_load(prefix, *a, **k)

    def recording_verify(prefix):
        ok, reason = real_verify(prefix)
        verified.append((os.path.basename(prefix), ok, reason))
        return ok, reason

    shuffle, ds.shuffle = ds.shuffle, False
    runs = []
    try:
        for plan in ("", P21_FAULT_PLAN):
            os.environ["BIGDL_TORCH_FAULT_PLAN"] = plan
            reset_injector()
            model = _p21_resnet(True)
            ck = os.path.join(tmp, "ck_fault" if plan else "ck_clean")
            opt = _p21_trainer(model, ds, end=Trigger.max_iteration(
                P21_SHORT_STEPS), ck=ck, every=P21_FAULT_CKPT_EVERY)
            S.load_checkpoint = recording_load
            S.verify_checkpoint = recording_verify
            try:
                RandomGenerator.RNG.set_seed(1)
                opt.optimize()
            finally:
                S.load_checkpoint = real_load
                S.verify_checkpoint = real_verify
            torch.cuda.synchronize()
            runs.append((_p21_host(model), opt.retries, ck))
            del opt, model
            torch.cuda.empty_cache()
    finally:
        os.environ.pop("BIGDL_TORCH_FAULT_PLAN", None)
        reset_injector()
        ds.shuffle = shuffle
    (clean, _, _), (faulted, retries, _) = runs
    same = all(torch.equal(a, b) for a, b in zip(clean, faulted))
    first = f"checkpoint_1_{P21_FAULT_CKPT_EVERY + 1}"
    second = f"checkpoint_1_{2 * P21_FAULT_CKPT_EVERY + 1}"
    say(f"phase 21 (c) BIGDL_TORCH_FAULT_PLAN={P21_FAULT_PLAN!r} (shuffle "
        f"off, checkpoints every {P21_FAULT_CKPT_EVERY}): {retries} retry; "
        f"the retry's verify {verified}, loaded {loaded}; final weights and "
        f"BN state bit-equal to the uninterrupted run {same}")
    if retries != 1 or loaded != [first] or not same:
        raise AssertionError("phase 21 (c): the retry did not resume from "
                             "the first intact checkpoint bit-equal")
    if [v[:2] for v in verified] != [(second, False), (first, True)] \
            or "checksum" not in verified[0][2]:
        raise AssertionError("phase 21 (c): the corrupted checkpoint "
                             "passed verification")

    os.environ["BIGDL_TORCH_FAULT_PLAN"] = P21_NAN_PLAN
    reset_injector()
    try:
        model = _p21_resnet(True)
        summary = _p21_recording_summary(os.path.join(tmp, "tb_nan"))
        opt = _p21_trainer(model, ds, summary, Trigger.max_iteration(4))
        RandomGenerator.RNG.set_seed(1)
        opt.optimize()
        torch.cuda.synchronize()
    finally:
        os.environ.pop("BIGDL_TORCH_FAULT_PLAN", None)
        reset_injector()
    skips = summary.read_scalar("NonFiniteSkips")
    finite = all(torch.isfinite(v).all() for v in _p21_host(model))
    say(f"phase 21 (c) {P21_NAN_PLAN!r}: loss at step 3 "
        f"{summary.loss.get(3)}, nonfinite_skips "
        f"{opt.state['nonfinite_skips']}, the summary's NonFiniteSkips "
        f"{skips}, weights finite {finite}")
    summary.close()
    if opt.state["nonfinite_skips"] != 1 or skips != [(3, 1.0)] \
            or not finite:
        raise AssertionError("phase 21 (c): the NaN step was not skipped")
    del opt, model
    torch.cuda.empty_cache()


def _phase21_bigdl_file(model, val_frame, tmp: str) -> None:
    """(d): the trained model through a ``.bigdl`` file and back onto
    the card; ``predict_image`` over the validation frame."""
    from bigdl_tpu_torch.optim import predict_image
    from bigdl_tpu_torch.utils import serializer as S
    from bigdl_tpu_torch.utils import tree as T

    path = os.path.join(tmp, "resnet50.bigdl")
    model.evaluate()
    t0 = time.perf_counter()
    S.save_module(model, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = S.load_module(path).to(DEV)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    pairs = list(zip(T.leaves(loaded.params()) + T.leaves(loaded.state()),
                     T.leaves(model.params()) + T.leaves(model.state())))
    same = len(pairs) > 0 and all(torch.equal(a, b) for a, b in pairs) \
        and len(T.leaves(loaded.params())) == len(T.leaves(model.params()))
    predict_image(loaded, val_frame, batch_size=IMG_BATCH, device=DEV)
    preds = np.stack([f["predict"] for f in val_frame.features])
    x = torch.from_numpy(np.stack([np.asarray(f["sample"].features)
                                   for f in val_frame.features])).to(DEV)
    with torch.no_grad():
        want = torch.cat([model(x[i:i + IMG_BATCH])
                          for i in range(0, x.shape[0], IMG_BATCH)]).cpu()
    err = float(np.max(np.abs(preds - want.numpy())))
    labels = np.asarray([f["label"] for f in val_frame.features])
    top1 = float(np.mean(np.argmax(preds, axis=1) + 1 == labels))
    say(f"phase 21 (d) save_module -> {os.path.getsize(path)} bytes of "
        f".bigdl in {save_s:.2f} s, load_module + .to(card) {load_s:.2f} s; "
        f"{len(pairs)} parameter and state tensors bit-equal {same}; "
        f"predict_image over {len(labels)} val images within {err:.3e} "
        f"of the trained model's eval forward (limit {P21_PRED_TOL:g}); "
        f"Top1 {top1:.4f}")
    if not same or not err <= P21_PRED_TOL:
        raise AssertionError("phase 21 (d): the .bigdl round trip or "
                             "predict_image is off")
    del loaded
    torch.cuda.empty_cache()


def _p21_stream_run(ck: str, plan: str = ""):
    """(e): the JAX stream tests' MLP through ``DistriOptimizer`` on a
    ``StreamDataSet`` with a small buffer, background checkpoints."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset import StreamDataSet, SyntheticStream
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, Linear, LogSoftMax,
                                    ReLU, Sequential)
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger
    from bigdl_tpu_torch.resilience.faults import reset_injector

    os.environ["BIGDL_TORCH_FAULT_PLAN"] = plan
    reset_injector()
    try:
        RandomGenerator.RNG.set_seed(7)
        model = Sequential().add(Linear(16, 32)).add(ReLU()) \
            .add(Linear(32, 4)).add(LogSoftMax()).to(DEV)
        ds = StreamDataSet(SyntheticStream(feature_dim=16, n_classes=4,
                                           seed=0), batch_size=32,
                           buffer_records=STREAM_BUFFER, audit_log=True)
        opt = DistriOptimizer(model, ds, ClassNLLCriterion(), 32,
                              wire_dtype="float32", device=DEV)
        opt.set_optim_method(SGD(learningrate=0.5, momentum=0.9))
        opt.set_end_when(Trigger.max_iteration(STREAM_STEPS))
        opt.set_checkpoint(ck, Trigger.several_iteration(STREAM_CKPT_EVERY),
                           background=True)
        opt.optimize()
        torch.cuda.synchronize()
    finally:
        os.environ.pop("BIGDL_TORCH_FAULT_PLAN", None)
        reset_injector()
    return model, opt, ds


def _phase21_stream(tmp: str) -> None:
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs import names

    obs.reset()
    ref, _, ref_ds = _p21_stream_run(os.path.join(tmp, "ck_s0"))
    model, opt, ds = _p21_stream_run(os.path.join(tmp, "ck_s1"),
                                     f"step:{STREAM_RAISE_AT}:raise")
    fams = {f.name: f for f in obs.get_registry().families()}

    def value(name):
        items = fams[name].child_items() if name in fams else []
        return items[0][1].value if items else None

    offset = ds.stream_checkpoint_state()["offset"]
    same = all(torch.equal(a, b)
               for a, b in zip(_p21_host(model), _p21_host(ref)))
    flat = [o for s, e in ds.audit_log for o in range(s, e)]
    resumed = (STREAM_RAISE_AT - 1) // STREAM_CKPT_EVERY * STREAM_CKPT_EVERY
    want = list(range((STREAM_RAISE_AT - 1) * 32)) + list(
        range(resumed * 32, STREAM_STEPS * 32))
    ref_flat = [o for s, e in ref_ds.audit_log for o in range(s, e)]
    waits = value(names.STREAM_BACKPRESSURE_WAITS_TOTAL)
    say(f"phase 21 (e) StreamDataSet(SyntheticStream(16, 4, seed 0)), "
        f"batch 32, buffer {STREAM_BUFFER} records, the stream tests' MLP "
        f"through DistriOptimizer on the card, {STREAM_STEPS} steps, "
        f"step:{STREAM_RAISE_AT}:raise: {opt.retries} retry, trained offset "
        f"{offset} (want {STREAM_STEPS * 32}); the retried run's records "
        f"as the audit saw them match the replay from offset "
        f"{resumed * 32} {flat == want}; the uninterrupted run trained "
        f"0..{STREAM_STEPS * 32} once {ref_flat == list(range(STREAM_STEPS * 32))}"
        f"; final weights bit-equal {same}; buffer depth gauge "
        f"{value(names.STREAM_BUFFER_DEPTH)}, backpressure waits {waits}, "
        f"records {value(names.STREAM_RECORDS_TOTAL)}")
    if opt.retries != 1 or offset != STREAM_STEPS * 32 or not same \
            or flat != want or ref_flat != list(range(STREAM_STEPS * 32)):
        raise AssertionError("phase 21 (e): the stream did not resume "
                             "exactly once")
    if not waits:
        raise AssertionError("phase 21 (e): the buffer never pushed back")
    obs.reset()


def phase_image_pipeline(smi: str) -> dict:
    """Phase 21: ImageFrame and the vision transforms into the fused
    ResNet-50 through DistriOptimizer with background checkpoints,
    TensorBoard summaries, the fault plan, a ``.bigdl`` file,
    ``predict_image`` and the stream.  Returns the conv_bn launches of
    (a), its main path."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase21_")
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    try:
        root = os.path.join(tmp, "data")
        _write_image_folder(root)
        Engine.init(DEV)
        opt, model, ds, val_frame = _phase21_main(root, tmp, smi)
        launches = {k: _cuda.launches[k]
                    for k in ("conv_bn_1x1", "conv_bn_kxk")}
        opt.checkpoint_trigger = opt.validation_trigger = None
        opt.train_summary = None
        phase_train_profile(opt, 21, "ImageFrame ResNet-50 step")
        del opt
        _phase21_bigdl_file(model, val_frame, tmp)
        del model, val_frame
        torch.cuda.empty_cache()
        # (b) and (c) compare runs bit for bit
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        _phase21_background(ds, tmp, smi)
        _phase21_faults(ds, tmp)
        _phase21_stream(tmp)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det
        Engine.reset()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    say(f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- phase 22: what DistriOptimizer still lacked --------------------------
def _p22_trainer(model, x, y, **kw):
    """Phase 7's fused ResNet-50 recipe through ``DistriOptimizer`` at
    world 1 (bf16 compute), SGD with momentum, one batch an epoch."""
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger

    opt = DistriOptimizer(model, (x, y), CrossEntropyCriterion(),
                          TRAIN_BATCH, device=DEV, **kw)
    opt.set_optim_method(SGD(learningrate=P22_LR, momentum=0.9))
    opt.set_compute_dtype("bfloat16")
    opt.set_end_when(Trigger.max_iteration(P22_STEPS))
    return opt


class _P22Summary(_TimedLosses):
    """Losses with their read times, and each health sample."""

    def __init__(self):
        super().__init__()
        self.health = {}

    def add_health(self, step, layers):
        self.health[step] = layers

    def get_summary_trigger(self, name):
        return None


def _p22_run(x, y, **kw):
    """One 8-step run: (model, optimizer, summary, f64 squared norm of
    each step's pre-clip gradient, the last step's padded flat
    gradient, steady step ms)."""
    from bigdl_tpu_torch.common import RandomGenerator

    model = _training_resnet50(True)
    RandomGenerator.RNG.set_seed(1)
    opt = _p22_trainer(model, x, y, **kw)
    summary = _P22Summary()
    opt.set_train_summary(summary)
    sq, last = {}, {}
    clip = opt._clipper

    def recording_clip(grads, global_sq=None):
        g = grads[0]
        sq[opt.state["neval"]] = g.double().pow(2).sum()
        last["g"] = g
        return clip(grads, global_sq=global_sq)

    # the trainer calls its clipper only when it says a clip is set;
    # this one records every step's gradient (with no clip set it
    # passes the gradient through as it is)
    recording_clip.active = True
    opt._clipper = recording_clip
    opt.optimize()
    torch.cuda.synchronize()
    at = summary.at
    gaps = [at[n + 1] - at[n] for n in sorted(at) if n >= 2 and n + 1 in at]
    step_ms = float(np.median(gaps)) * 1e3
    return model, opt, summary, {n: float(v) for n, v in sq.items()}, \
        last["g"].detach().clone(), step_ms


def _phase22_main(smi: str, tmp: str):
    """(a): the f32 monolithic run, then the int8 + EF + buckets run
    with health, spans and the obs server; their gates.  Returns (the
    conv_bn launches of the main run, the last flat gradient, the main
    run's optimizer)."""
    import urllib.request

    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs import health as H
    from bigdl_tpu_torch.obs import runtime as R
    from bigdl_tpu_torch.obs import server
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.utils import tree as T

    x = np.random.RandomState(0).randn(
        TRAIN_BATCH, 3, TRAIN_IMG, TRAIN_IMG).astype(np.float32)
    y = (np.random.RandomState(1).randint(0, TRAIN_CLASSES, TRAIN_BATCH)
         + 1).astype(np.float32)
    ref, ref_opt, ref_sum, _, _, off_ms = _p22_run(x, y,
                                                    wire_dtype="float32")
    ref_w = [v.detach().clone() for v in T.leaves(ref.params())]
    del ref, ref_opt
    torch.cuda.empty_cache()
    env = {"BIGDL_TORCH_HEALTH_EVERY": str(P22_HEALTH_EVERY),
           "BIGDL_TORCH_OBS_PORT": "0",
           "BIGDL_TORCH_TRACE_DIR": os.path.join(tmp, "trace"),
           "BIGDL_TORCH_HANG_TIMEOUT": str(P22_HANG_S)}
    os.environ.update(env)
    torch.cuda.reset_peak_memory_stats()
    try:
        # the slice's main path: counts from 0 just before, read after
        _cuda.reset_launches()
        model, opt, summary, sq, flat_g, on_ms = _p22_run(
            x, y, wire_dtype="int8", wire_ef=True,
            overlap_bucket_mb=P22_BUCKET_MB, wire_block=P22_BLOCK)
        launches = {k: _cuda.launches[k]
                    for k in ("conv_bn_1x1", "conv_bn_kxk")}
        srv = server.get_server()
        with urllib.request.urlopen(srv.url("/healthz"), timeout=30) as r:
            hz = json.loads(r.read())
        peak = R.device_memory_stats()["peak_bytes_in_use"]
        buckets = opt._buckets
        say(f"phase 22 (a) losses f32 "
            f"{['%.5f' % ref_sum.loss[n] for n in sorted(ref_sum.loss)]}, "
            f"int8+EF+{len(buckets)} buckets "
            f"{['%.5f' % summary.loss[n] for n in sorted(summary.loss)]}")
        if hz["step"] != P22_STEPS or hz["status"] != "ok":
            raise AssertionError(f"phase 22 (a): /healthz {hz}")
        got_w = [v.detach() for v in T.leaves(model.params())]
        bad = [i for i, (a, b) in enumerate(zip(got_w, ref_w))
               if not torch.equal(a, b)]
        if bad or len(buckets) < 2:
            raise AssertionError(f"phase 22 (a): {len(bad)} parameter "
                                 f"tensors differ from the f32 monolithic "
                                 f"run ({len(buckets)} buckets)")
        want = (36 * P22_STEPS, 16 * P22_STEPS)
        if (launches["conv_bn_1x1"], launches["conv_bn_kxk"]) != want:
            raise AssertionError(f"phase 22 (a): conv_bn launches "
                                 f"{launches}, want {want}")
        if "wire_ef" not in opt.optim_method.state or \
                opt.optim_method.state["wire_ef"].abs().max().item() != 0:
            raise AssertionError("phase 22 (a): the world-1 EF residual "
                                 "is not the zeros the identity wire leaves")
        # each health report against the phase's own f64 squared norm
        reports = sorted(summary.health)
        if reports != list(range(P22_HEALTH_EVERY, P22_STEPS + 1,
                                 P22_HEALTH_EVERY)):
            raise AssertionError(f"phase 22 (a): health reports at "
                                 f"{reports}")
        worst = 0.0
        for n in reports:
            got = sum(r["grad_norm"] ** 2
                      for r in summary.health[n].values())
            worst = max(worst, abs(got - sq[n]) / sq[n])
        check("phase 22 (a) health grad_sq vs the gradient's norm", worst,
              P22_HEALTH_REL)
        # the step spans in the tracer's ring
        spans = {}
        for rec in obs.get_tracer().recent():
            if rec.get("kind") == "span":
                spans.setdefault(rec["name"], set()).add(
                    (rec.get("attrs") or {}).get("step"))
        for name in ("iteration", "batch_prep", "device_put",
                     "step_dispatch", "computing"):
            if P22_STEPS not in spans.get(name, ()):
                raise AssertionError(f"phase 22 (a): no {name} span of "
                                     f"step {P22_STEPS} in the ring")
        time.sleep(2 * P22_HANG_S)
        with urllib.request.urlopen(srv.url("/healthz"), timeout=30) as r:
            stalled = json.loads(r.read())
        if stalled["status"] != "stalled":
            raise AssertionError(f"phase 22 (a): /healthz idle {stalled}")
        # the health report's own cost at this size: the stats on the
        # card, then the read-back and summary on the host
        flat_w = opt._flat
        stats_ms = time_ms(lambda: H.flat_shard_stats(
            flat_g, flat_w, flat_w, 0, opt._boundaries,
            positions=opt._positions), device_only=True)
        t0 = time.perf_counter()
        for _ in range(10):
            H.summarize(H.flat_shard_stats(
                flat_g, flat_w, flat_w, 0, opt._boundaries,
                positions=opt._positions).cpu().numpy(),
                opt._health_monitor.names)
        report_ms = (time.perf_counter() - t0) * 1e2
        rt = opt._obs_runtime.snapshot(memory=False)
        say(f"phase 22 (a) 36/16 conv_bn launches a step; bit-equal to the "
            f"f32 monolithic run; health grad_sq within {worst:.2e}; "
            f"/healthz step {hz['step']} then '{stalled['status']}' after "
            f"{stalled['step_age_s']:.2f} s idle; {len(buckets)} buckets "
            f"of {buckets[0][1] * 4 / 2 ** 20:.1f} MiB at world 1")
        say(f"phase 22 (a) step {on_ms:.3f} ms ({TRAIN_BATCH / on_ms * 1e3:.1f}"
            f" images/s) with the int8 wire, buckets, health every "
            f"{P22_HEALTH_EVERY} and spans on; {off_ms:.3f} ms "
            f"({TRAIN_BATCH / off_ms * 1e3:.1f} images/s) f32 with them off; "
            f"runtime p50 {rt['step_time_s']['p50'] * 1e3:.3f} ms, dispatch "
            f"p50 {rt['dispatch_time_s']['p50'] * 1e3:.3f} ms; health stats "
            f"{stats_ms:.3f} ms on the device, a whole report "
            f"{report_ms:.3f} ms; peak memory {peak / 2 ** 30:.2f} GiB "
            f"(obs/runtime); {smi}")
    finally:
        for k in env:
            os.environ.pop(k, None)
        server.stop_server()
        obs.reset()
    return launches, flat_g, opt


def _phase22_wire(flat_g, smi: str) -> None:
    """(b): the quantizers on the card against the card machine's CPU,
    their times, and each wire's bytes a step from the byte model."""
    from bigdl_tpu_torch.obs import collectives as C
    from bigdl_tpu_torch.parallel import wire as Wr

    elems = flat_g.numel()
    padded = Wr.padded_elems(elems, Wr.WireSpec("int8", P22_BLOCK), 1)
    g = torch.cat([flat_g, flat_g.new_zeros(padded - elems)])
    g_cpu = g.cpu()
    for dtype in ("bfloat16", "int8", "fp8_e4m3", "fp8_e5m2"):
        spec = Wr.WireSpec(dtype, P22_BLOCK)
        payload, scales = Wr.quantize(g, spec)
        p_cpu, s_cpu = Wr.quantize(g_cpu, spec)
        same = torch.equal(payload.cpu().view(torch.uint8),
                           p_cpu.view(torch.uint8)) and (
            scales is None or torch.equal(scales.cpu(), s_cpu))
        deq = Wr.dequantize(payload, scales, spec, shape=g.shape)
        same = same and torch.equal(
            deq.cpu(), Wr.dequantize(p_cpu, s_cpu, spec, shape=g.shape))
        if not same:
            raise AssertionError(f"phase 22 (b) {dtype}: the card's payload "
                                 "or scales differ from the CPU's")
        if dtype == "int8":
            amax = g.view(-1, P22_BLOCK).abs().amax(dim=1, keepdim=True)
            # amax / 254 is the exact bound; x / scale and q * scale
            # each round once in f32
            over = ((deq - g).view(-1, P22_BLOCK).abs()
                    - amax / 254 * (1 + 1e-6) - amax * 2.0 ** -23).max().item()
            if over > 0:
                raise AssertionError(f"phase 22 (b): int8 error over "
                                     f"amax/254 by {over:.3e}")
        q_ms = time_ms(lambda: Wr.quantize(g, spec), device_only=True)
        d_ms = time_ms(lambda: Wr.dequantize(payload, scales, spec),
                       device_only=True)
        per_world = []
        for n in (2, 8):
            pad_n = Wr.padded_elems(elems, spec, n)
            ring = sum(C.staged_ring_exchange_bytes(
                pad_n, n, P22_BLOCK, spec.wire_name).values()) \
                if spec.scaled else C.reduce_scatter_bytes(pad_n, dtype, n)
            f32 = C.reduce_scatter_bytes(pad_n, "float32", n)
            per_world.append(f"world {n} {ring / 2 ** 20:.2f} MiB vs f32 "
                             f"{f32 / 2 ** 20:.2f} MiB")
        say(f"phase 22 (b) {dtype}: payload and scales bit-equal to the "
            f"CPU's over {padded} elements; quantize {q_ms:.4f} ms, "
            f"dequantize {d_ms:.4f} ms on the device (25 runs); a rank "
            f"ships a step (obs/collectives model, world 1 ships 0): "
            f"{'; '.join(per_world)}; {smi}")


def _phase22_resume(tmp: str) -> None:
    """(c): the tests' two-rank worker checkpoints at world 2 over gloo
    on the CPU; the card resumes at world 1, against the CPU's
    resume."""
    import importlib.util

    from bigdl_tpu_torch import nn as TN
    from bigdl_tpu_torch import optim as TO
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.parallel import wire as Wr
    from bigdl_tpu_torch.utils import serializer as S
    from bigdl_tpu_torch.utils import tree as T

    root = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(root, "tests", "torch_port_distri_worker.py")
    spec = importlib.util.spec_from_file_location("p22_worker", worker)
    W = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(W)
    ck = os.path.join(tmp, "ck_world2")
    store = os.path.join(tmp, "store")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), "2", store, ck, "ckpt"], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        if p.returncode:
            raise AssertionError(f"phase 22 (c) world-2 writer: {log[-2000:]}")
    prefix = os.path.join(ck, S.checkpoint_prefixes(ck)[-1])
    topo = S.read_checkpoint_topology(prefix)
    with np.load(prefix + ".optim.npz") as f:
        saved = {k: np.array(f[k]) for k in ("velocity", "wire_ef")}
    x, y = W.data(W.CKPT_N)

    def resume(device):
        snaps = []

        class Snap(TO.DistriOptimizer):
            def _init_opt_state(self, params, tree):
                super()._init_opt_state(params, tree)
                snaps.append({k: v.detach().cpu().clone()
                              for k, v in self.optim_method.state.items()})

        Engine.reset()
        RandomGenerator.RNG.set_seed(4)
        make = lambda m, d: Snap(  # noqa: E731
            m, d, TN.ClassNLLCriterion(), 8, device=device, **W.CKPT_KW)
        model, opt, losses = W.ckpt_run(
            TN, TO, make, ArrayDataSet(x, y, 8, shuffle=False), resume=ck)
        out = [v.detach().cpu() for v in T.leaves(model.params())]
        return snaps[0], [losses.loss[n] for n in sorted(losses.loss)], out, \
            opt

    card_state, card_loss, card_w, opt = resume(DEV)
    elems, pad = opt._flat_elems, opt._pad
    # the expected re-laid vector: the writer's shard-major order undone,
    # its padding stripped, this world's padding appended (one rank: the
    # shard-major order of this run's buckets is the flat one)
    flat = np.zeros_like(saved["velocity"])
    flat[Wr.bucket_param_coords(topo["buckets"], topo["world_size"])] = \
        saved["velocity"]
    want = np.concatenate([flat[:elems], np.zeros(pad, np.float32)])
    if not np.array_equal(card_state["velocity"].numpy(), want):
        raise AssertionError("phase 22 (c): the re-laid velocity is not the "
                             "un-permuted, re-padded writer's vector")
    if card_state["wire_ef"].abs().max().item() != 0 or \
            not np.abs(saved["wire_ef"]).max() > 0:
        raise AssertionError("phase 22 (c): wire_ef not reset to zeros")
    cpu_state, cpu_loss, cpu_w, _ = resume("cpu")
    Engine.reset()
    gap = max([abs(a - b) for a, b in zip(card_loss, cpu_loss)]
              + [float((a - b).abs().max()) for a, b in zip(card_w, cpu_w)])
    if len(card_loss) != 4 or gap > P22_RESUME_TOL or not torch.equal(
            cpu_state["velocity"], card_state["velocity"]):
        raise AssertionError(f"phase 22 (c): the card's resume is {gap:.3e} "
                             f"from the CPU's ({len(card_loss)} steps)")
    say(f"phase 22 (c) world-{topo['world_size']} checkpoint ({len(topo['buckets'])} "
        f"buckets, int8 + EF) resumed at world 1: velocity re-laid bit-equal, "
        f"wire_ef reset, the 4 steps of epoch 2 within {gap:.2e} of the "
        "CPU's resume")


_P22_CHILD = r"""
import sys, time
import numpy as np, torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.dataset import ArrayDataSet
from bigdl_tpu_torch.dataset.mnist import load_mnist, normalize
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.models.lenet import build_lenet5
from bigdl_tpu_torch.nn import ClassNLLCriterion
from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger
from bigdl_tpu_torch.resilience import elastic
from bigdl_tpu_torch.utils import tree as T
mode, ck, out, n, batch, epochs, hold, dev = sys.argv[1:9]


class Hold:
    def add_scalar(self, tag, value, step):
        if mode == "preempt" and tag == "Loss" and step == int(hold):
            print("STEP", step, flush=True)
            deadline = time.time() + 120
            while not elastic.preemption_requested():
                if time.time() > deadline:
                    raise RuntimeError("no SIGTERM arrived")
                time.sleep(0.01)

    def get_summary_trigger(self, name):
        return None


def main():
    RandomGenerator.RNG.set_seed(0)
    model = build_lenet5(device=dev)
    x, y = load_mnist(None, "train", synthetic_n=int(n))
    opt = DistriOptimizer(model, ArrayDataSet(normalize(x), y, int(batch),
                                              shuffle=False),
                          ClassNLLCriterion(), int(batch), device=dev,
                          wire_dtype="int8", wire_ef=True)
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_epoch(int(epochs)))
    opt.set_checkpoint(ck, Trigger.every_epoch())
    opt.set_train_summary(Hold())
    if mode == "resume":
        print("RESUMED", elastic.restore_latest(opt)["neval"], flush=True)
    opt.optimize()
    if dev == "cuda":
        torch.cuda.synchronize()
    np.savez(out, *[v.detach().cpu().numpy()
                    for v in T.leaves(model.params())
                    + T.leaves(model.state())])


try:
    main()
finally:
    Engine.reset()
"""


def _phase22_preempt(tmp: str) -> None:
    """(d): SIGTERM to a LeNet-5 child after step 3; its emergency
    checkpoint resumed by ``restore_latest`` in a second child, against
    an uninterrupted child."""
    import signal

    from bigdl_tpu_torch.utils import serializer as S

    root = os.path.dirname(os.path.abspath(__file__))
    args = [str(P22_LENET_N), str(P22_LENET_BATCH), str(P22_LENET_EPOCHS),
            str(P22_HOLD), DEV]

    def child(mode, ck, out):
        return subprocess.Popen(
            [sys.executable, "-c", _P22_CHILD, mode, ck, out] + args,
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    t0 = time.perf_counter()
    ck = os.path.join(tmp, "ck_pre")
    ref = child("plain", os.path.join(tmp, "ck_ref"),
                os.path.join(tmp, "ref.npz"))
    pre = child("preempt", ck, os.path.join(tmp, "never.npz"))
    seen = []
    try:
        for line in pre.stdout:
            seen.append(line)
            if line.startswith("STEP"):
                t_sig = time.perf_counter()
                pre.send_signal(signal.SIGTERM)
                break
        rest = pre.communicate(timeout=300)[0]
        exit_s = time.perf_counter() - t_sig if seen and \
            seen[-1].startswith("STEP") else float("nan")
        ref_out = ref.communicate(timeout=300)[0]
    finally:
        pre.kill()
        ref.kill()
    if pre.returncode != 170 or os.path.exists(os.path.join(tmp,
                                                            "never.npz")):
        raise AssertionError(f"phase 22 (d): the preempted child exited "
                             f"{pre.returncode}: {''.join(seen)[-1500:]}"
                             f"{rest[-1500:]}")
    if ref.returncode:
        raise AssertionError(f"phase 22 (d) uninterrupted child: "
                             f"{ref_out[-2000:]}")
    names_ = S.checkpoint_prefixes(ck)
    if not names_ or not S.verify_checkpoint(os.path.join(ck,
                                                          names_[-1]))[0]:
        raise AssertionError("phase 22 (d): no intact emergency checkpoint")
    neval = S.read_checkpoint_topology(os.path.join(ck, names_[-1]))["step"]
    res = child("resume", ck, os.path.join(tmp, "resumed.npz"))
    out = res.communicate(timeout=300)[0]
    if res.returncode or f"RESUMED {neval}" not in out:
        raise AssertionError(f"phase 22 (d) resume: {out[-2000:]}")
    a = np.load(os.path.join(tmp, "resumed.npz"))
    b = np.load(os.path.join(tmp, "ref.npz"))
    if a.files != b.files or not all(np.array_equal(a[k], b[k])
                                     for k in a.files):
        raise AssertionError("phase 22 (d): the resumed run is not bit-equal "
                             "to the uninterrupted one")
    say(f"phase 22 (d) SIGTERM after step {P22_HOLD}: exit 170 in "
        f"{exit_s:.2f} s with the emergency checkpoint at neval {neval}; "
        f"restore_latest ends bit-equal to the uninterrupted run "
        f"({len(a.files)} arrays); (d) took "
        f"{time.perf_counter() - t0:.1f} s")


def phase_distri_resilience(smi: str) -> dict:
    """Phase 22: DistriOptimizer's int8/fp8 wires with error feedback,
    buckets, health, spans and /healthz on the fused ResNet-50, the
    quantizers on the card, a world-2 checkpoint resumed on the card,
    and preemption.  Returns the conv_bn launches of (a), its main
    path."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.engine import Engine

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase22_")
    det = (torch.backends.cudnn.deterministic,
           torch.backends.cudnn.benchmark)
    try:
        # (a) compares two runs bit for bit
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        Engine.init(DEV)
        launches, flat_g, opt = _phase22_main(smi, tmp)
        del opt
        torch.cuda.empty_cache()
        _phase22_wire(flat_g, smi)
        del flat_g
        torch.cuda.empty_cache()
        _phase22_resume(tmp)
        _phase22_preempt(tmp)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = det
        Engine.reset()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    say(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---- phase 23: Wide & Deep, the tree-LSTM, AlexNet, item 16's layers ----
def _p23_sparse(rows, cols, per_row, seed, ids=False):
    """A COO (rows, cols) SparseTensor with ``per_row`` entries a row:
    values uniform in [0.5, 1.5), or 1-based ids below ``cols``."""
    from bigdl_tpu_torch.nn import SparseTensor

    rs = np.random.RandomState(seed)
    r = np.repeat(np.arange(rows), per_row)
    c = np.tile(np.arange(per_row), rows) if ids else \
        rs.randint(0, cols, rows * per_row)
    v = (rs.randint(0, cols, rows * per_row) + 1).astype(np.float32) \
        if ids else rs.uniform(0.5, 1.5, rows * per_row).astype(np.float32)
    return SparseTensor(np.stack([r, c], 1), v,
                        (rows, per_row if ids else cols))


def _p23_rois():
    rs = np.random.RandomState(5)
    x1, y1 = rs.uniform(0, 180, (2, 32))
    w, h = rs.uniform(16, 70, (2, 32))
    img = rs.randint(1, 3, 32)
    return np.stack([img, x1, y1, x1 + w, y1 + h], 1).astype(np.float32)


def _p23_conn():
    return [[i + 1, i % 8 + 1] for i in range(16)] + \
        [[i + 1, (i + 3) % 8 + 1] for i in range(16)]


_IMG = (8, 16, 28, 28)
_VOL = (4, 8, 8, 16, 24)
_SEQ = (32, 100, 32)
# Phase 23 (d)'s cases, one or more a class of item 16 (and Remat), at
# about 1e5 elements an input, in phase 19 (d)'s form; SparseJoinTable
# moves host arrays only and has no case
ITEM16_CASES = [
    ("conv", "LocallyConnected1D", lambda N: N.LocallyConnected1D(
        100, 32, 32, 5, 2), lambda: _tc(_SEQ, 0), None, False),
    ("conv", "LocallyConnected2D", lambda N: N.LocallyConnected2D(
        8, 28, 24, 8, 3, 3, 2, 2, 1, 1), lambda: _tc((16, 8, 24, 28), 0),
     None, False),
    ("conv", "SpatialSeparableConvolution",
     lambda N: N.SpatialSeparableConvolution(16, 32, 2, 3, 3, 1, 1, 1, 1),
     lambda: _tc(_IMG, 0), None, False),
    ("conv", "SpatialShareConvolution", lambda N: N.SpatialShareConvolution(
        16, 32, 3, 3, 1, 1, 1, 1), lambda: _tc(_IMG, 0), None, False),
    ("conv", "SpatialConvolutionMap", lambda N: N.SpatialConvolutionMap(
        _p23_conn(), 3, 3, 1, 1, 1, 1), lambda: _tc(_IMG, 0), None, False),
    ("conv", "SpatialSubtractiveNormalization",
     lambda N: N.SpatialSubtractiveNormalization(16),
     lambda: _tc(_IMG, 0), None, False),
    ("conv", "SpatialDivisiveNormalization",
     lambda N: N.SpatialDivisiveNormalization(16), lambda: _tc(_IMG, 0),
     None, False),
    ("conv", "SpatialContrastiveNormalization",
     lambda N: N.SpatialContrastiveNormalization(16), lambda: _tc(_IMG, 0),
     None, False),
    ("conv", "VolumetricConvolution", lambda N: N.VolumetricConvolution(
        8, 16, 3, 3, 3, 1, 1, 1, 1, 1, 1), lambda: _tc(_VOL, 0), None, False),
    ("conv", "VolumetricFullConvolution",
     lambda N: N.VolumetricFullConvolution(8, 8, 3, 3, 3, 2, 2, 2, 1, 1, 1,
                                           1, 1, 1),
     lambda: _tc((4, 8, 6, 12, 16), 0), None, False),
    ("conv", "VolumetricMaxPooling", lambda N: N.VolumetricMaxPooling(2),
     lambda: _tc(_VOL, 0), None, False),
    ("conv", "VolumetricAveragePooling",
     lambda N: N.VolumetricAveragePooling(3, 3, 3, 2, 2, 2, 1, 1, 1, False,
                                          True), lambda: _tc(_VOL, 0), None,
     False),
    ("conv", "VolumetricBatchNormalization",
     lambda N: N.VolumetricBatchNormalization(8), lambda: _tc(_VOL, 0),
     None, False),
    ("conv", "UpSampling3D", lambda N: N.UpSampling3D((2, 2, 2)),
     lambda: _tc((4, 8, 4, 8, 12), 0), None, False),
    ("conv", "Cropping3D", lambda N: N.Cropping3D((1, 1), (2, 2), (1, 2)),
     lambda: _tc(_VOL, 0), None, False),
] + [("rest", name, build, make, None, exact)
     for name, build, make, exact in [
    ("TemporalMaxPooling", lambda N: N.TemporalMaxPooling(3, 2),
     lambda: _tc(_SEQ, 0), False),
    ("TemporalAveragePooling", lambda N: N.TemporalAveragePooling(3),
     lambda: _tc(_SEQ, 0), False),
    ("SoftShrink", lambda N: N.SoftShrink(0.3), lambda: _tc(ITEM14_E, 0),
     False),
    ("HardShrink", lambda N: N.HardShrink(0.4), lambda: _tc(ITEM14_E, 0),
     False),
    ("TanhShrink", lambda N: N.TanhShrink(), lambda: _tc(ITEM14_E, 0),
     False),
    ("LogSigmoid", lambda N: N.LogSigmoid(), lambda: _tc(ITEM14_E, 0, 4.0),
     False),
    ("RReLU", lambda N: N.RReLU(), lambda: _tc(ITEM14_E, 0), False),
    ("GaussianDropout", lambda N: N.GaussianDropout(0.3),
     lambda: _tc(ITEM14_E, 0), False),
    ("GaussianNoise", lambda N: N.GaussianNoise(0.2),
     lambda: _tc(ITEM14_E, 0), False),
    ("GaussianSampler", lambda N: N.GaussianSampler(),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False),
    ("SpatialDropout1D", lambda N: N.SpatialDropout1D(0.4),
     lambda: _tc(_SEQ, 0), False),
    ("SpatialDropout2D", lambda N: N.SpatialDropout2D(0.4),
     lambda: _tc(_IMG, 0), False),
    ("SpatialDropout3D", lambda N: N.SpatialDropout3D(0.4),
     lambda: _tc(_VOL, 0), False),
    ("Cropping2D", lambda N: N.Cropping2D((2, 3), (1, 4)),
     lambda: _tc(_IMG, 0), False),
    ("UpSampling1D", lambda N: N.UpSampling1D(2),
     lambda: _tc((32, 50, 32), 0), False),
    ("UpSampling2D", lambda N: N.UpSampling2D((2, 2)),
     lambda: _tc((8, 16, 14, 14), 0), False),
    ("ResizeBilinear", lambda N: N.ResizeBilinear(40, 36),
     lambda: _tc(_IMG, 0), False),
    ("ResizeBilinear align", lambda N: N.ResizeBilinear(40, 36, True),
     lambda: _tc(_IMG, 0), False),
    ("ResizeBilinear half", lambda N: N.ResizeBilinear(20, 18, False, True),
     lambda: _tc(_IMG, 0), False),
    ("ResizeNearestNeighbor", lambda N: N.ResizeNearestNeighbor(40, 36),
     lambda: _tc(_IMG, 0), False),
    ("ResizeNearestNeighbor align",
     lambda N: N.ResizeNearestNeighbor(14, 10, True), lambda: _tc(_IMG, 0),
     False),
    ("DepthToSpace", lambda N: N.DepthToSpace(2),
     lambda: _tc((8, 64, 14, 14), 0), False),
    ("SpaceToDepth", lambda N: N.SpaceToDepth(2), lambda: _tc(_IMG, 0),
     False),
    ("SpatialWithinChannelLRN", lambda N: N.SpatialWithinChannelLRN(5),
     lambda: _tc(_IMG, 0), False),
    ("ExpandSize", lambda N: N.ExpandSize([256, -1, 4]),
     lambda: _tc((1, 100, 1), 0), False),
    ("InferReshape", lambda N: N.InferReshape([0, -1, 4], True),
     lambda: _tc(_IMG, 0), False),
    ("Tile", lambda N: N.Tile(2, 3), lambda: _tc((32, 32, 32), 0), False),
    ("SplitChunks", lambda N: N.SplitChunks(2, 4), lambda: _tc(_IMG, 0),
     False),
    ("GatherIndices", lambda N: N.GatherIndices(
        2, list(range(0, 16, 2)) + [-1]), lambda: _tc(_IMG, 0), False),
    ("Reverse", lambda N: N.Reverse(3), lambda: _tc(_IMG, 0), False),
    ("CumSum", lambda N: N.CumSum(2), lambda: _tc(ITEM14_E, 0), False),
    ("CumSum exclusive reverse", lambda N: N.CumSum(2, True, True),
     lambda: _tc(ITEM14_E, 0), False),
    ("FillLike", lambda N: N.FillLike(1.5), lambda: _tc(ITEM14_E, 0),
     False),
    ("MirrorPad", lambda N: N.MirrorPad([[0, 0], [0, 0], [2, 3], [1, 2]]),
     lambda: _tc(_IMG, 0), False),
    ("MirrorPad symmetric", lambda N: N.MirrorPad(
        [[0, 0], [1, 0], [2, 3], [1, 2]], "SYMMETRIC"),
     lambda: _tc(_IMG, 0), False),
    ("CompareConstant", lambda N: N.CompareConstant("gt", 0.1),
     lambda: _tc(ITEM14_E, 0), True),
    ("MaskedSelect", lambda N: N.MaskedSelect(),
     lambda: (_tc(ITEM14_E, 0), _tc_bits(ITEM14_E)), False),
    ("PairwiseDistance", lambda N: N.PairwiseDistance(2),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False),
    ("PairwiseDistance p3", lambda N: N.PairwiseDistance(3),
     lambda: (_tc(ITEM14_E, 0), _tc(ITEM14_E, 1)), False),
    ("Maxout", lambda N: N.Maxout(400, 64, 4), lambda: _tc(ITEM14_E, 0),
     False),
    ("Highway", lambda N: N.Highway(400, True, "Tanh"),
     lambda: _tc(ITEM14_E, 0), False),
    ("SReLU", lambda N: N.SReLU((400,)), lambda: _tc(ITEM14_E, 0, 2.0),
     False),
    ("RoiPooling", lambda N: N.RoiPooling(7, 7, 0.25),
     lambda: (_tc((2, 16, 64, 64), 0), _p23_rois()), False),
    ("NegativeEntropyPenalty", lambda N: N.NegativeEntropyPenalty(0.1),
     lambda: _tc(ITEM14_E, 0), False),
    ("SparseLinear", lambda N: N.SparseLinear(1000, 64),
     lambda: _p23_sparse(256, 1000, 40, 3), False),
    ("SparseLinear dense", lambda N: N.SparseLinear(1000, 64),
     lambda: _tc((256, 1000), 0), False),
    ("LookupTableSparse padded", lambda N: N.LookupTableSparse(
        10000, 32, "mean", 1.5),
     lambda: (_tc_ids((256, 64), 10000) * _tc_bits((256, 64)),
              _tc((256, 64), 0, lo=0.5, hi=1.5)), False),
    ("LookupTableSparse COO", lambda N: N.LookupTableSparse(
        10000, 32, "sqrtn"),
     lambda: (_p23_sparse(256, 10000, 64, 4, ids=True),
              _p23_sparse(256, 64, 64, 5)), False),
    ("BinaryTreeLSTM", lambda N: N.BinaryTreeLSTM(16, 32),
     lambda: (_tc((512, 15, 16), 0),
              __import__("bigdl_tpu_torch.nn.tree_lstm", fromlist=["x"])
              .random_binary_trees(512, 8, 0)[0].astype(np.float32)),
     False),
    ("Remat", lambda N: N.Remat(N.Sequential().add(N.Linear(400, 256))
                                .add(N.Tanh()).add(N.Linear(256, 400))),
     lambda: _tc(ITEM14_E, 0), False),
]]


def _phase23_cases() -> None:
    """(d): every class of item 16 (and Remat), forward and backward on
    the card against the CPU (and both against the CPU in f64)."""
    worst = {}
    for family, name, build, make, target, exact in ITEM16_CASES:
        limit = ITEM14_CONV_TOL if family == "conv" else ITEM14_TOL
        gap, rows = _item14_case(build, make, target, exact)
        for what, g, g_card, g_cpu in rows:
            if g > 1e-6:
                say(f"phase 23 (d) {name} {what}: card - CPU {g:.3e}; "
                    f"against f64 card {g_card:.3e}, CPU {g_cpu:.3e}")
        if not gap <= limit:
            raise AssertionError(f"{name}: card off the CPU by {gap:.3e}")
        n, w, at = worst.get(family, (0, -1.0, ""))
        worst[family] = (n + 1, max(w, gap), name if gap > w else at)
    for family, (n, w, at) in worst.items():
        limit = ITEM14_CONV_TOL if family == "conv" else ITEM14_TOL
        say(f"phase 23 (d) {family}: {n} cases, worst gap beyond an ulp "
            f"{w:.3e} of the largest magnitude ({at}; limit {limit:g})")


def _p23_step_ms(at: dict) -> float:
    """The median gap between successive loss reads from step 2 on, for
    a run of one batch an epoch (each read ends an epoch, so each gap is
    a whole step, nothing overlapped)."""
    gaps = [at[n + 1] - at[n] for n in sorted(at) if n >= 2 and n + 1 in at]
    return float(np.median(gaps)) * 1e3


def _p23_wd_data():
    """bench.py's wide_and_deep rows: (packed x, y) of its first batch."""
    from bigdl_tpu_torch.models import pack_batch
    from bigdl_tpu_torch.nn import SparseTensor

    rs = np.random.RandomState(0)
    n, wv = P23_WD_N, P23_WD_VOCAB
    cols = rs.randint(0, wv, (n, 4))
    rows = np.repeat(np.arange(n), 4)
    sp = SparseTensor(np.stack([rows, cols.reshape(-1)], 1),
                      np.ones(n * 4, np.float32), (n, wv))
    deep = np.stack([rs.randint(1, v + 1, n) for v in P23_WD_DEEP], 1)
    y = (rs.randint(0, 2, n) + 1).astype(np.float32)
    x = pack_batch(sp, deep, P23_WD_SLOTS)
    return x[:P23_WD_BATCH], y[:P23_WD_BATCH]


def _p23_wd_run(cls, device, steps, **kw):
    """Wide & Deep at bench's widths through ``cls`` on ``device``, one
    batch an epoch: (losses, read times, optimizer)."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models import build_wide_and_deep
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Trigger

    x, y = _p23_wd_data()
    RandomGenerator.RNG.set_seed(23)
    model = build_wide_and_deep(P23_WD_VOCAB, P23_WD_DEEP, class_num=2,
                                wide_slots=P23_WD_SLOTS)
    opt = cls(model, (x, y), ClassNLLCriterion(), P23_WD_BATCH,
              device=device, **kw)
    opt.set_optim_method(SGD(learningrate=P23_WD_LR))
    opt.set_end_when(Trigger.max_iteration(steps))
    losses = _TimedLosses()
    opt.set_train_summary(losses)
    opt.optimize()
    return [losses.loss[k] for k in sorted(losses.loss)], losses.at, opt


def _phase23_wide_deep(smi: str) -> None:
    """(a): Wide & Deep at bench's widths through both trainers on the
    card against the CPU, then the example's distributed main."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.examples import wide_and_deep_train as X
    from bigdl_tpu_torch.optim import DistriOptimizer, LocalOptimizer

    n = P23_WD_STEPS
    cpu, _, _ = _p23_wd_run(LocalOptimizer, "cpu", n)
    card, at, opt = _p23_wd_run(LocalOptimizer, DEV, 1 + n)
    step_ms = _p23_step_ms(at)
    phase_train_profile(opt, 23, "Wide & Deep LocalOptimizer step")
    del opt
    Engine.reset()
    Engine.init(DEV)
    distri, d_at, opt = _p23_wd_run(DistriOptimizer, DEV, 1 + n,
                                    wire_dtype="float32")
    d_ms = _p23_step_ms(d_at)
    phase_train_profile(opt, 23, "Wide & Deep DistriOptimizer step")
    del opt
    rel = max(abs(a - b) / abs(b) for a, b in zip(card[:n], cpu))
    d_rel = max(abs(a - b) / abs(b) for a, b in zip(distri[:n], card[:n]))
    argv = ["--distributed", "-e", "2"]
    RandomGenerator.RNG.set_seed(2)
    t0 = time.perf_counter()
    top1 = X.main(argv + ["--device", DEV])
    main_s = time.perf_counter() - t0
    Engine.reset()
    RandomGenerator.RNG.set_seed(2)
    top1_cpu = X.main(argv + ["--device", "cpu"])
    Engine.reset()
    say(f"phase 23 (a) Wide & Deep (bench.py's widths, batch "
        f"{P23_WD_BATCH}, f32): LocalOptimizer step {step_ms:.3f} ms "
        f"({P23_WD_BATCH / step_ms * 1e3:.1f} samples/s), DistriOptimizer "
        f"(world 1, NCCL) {d_ms:.3f} ms ({P23_WD_BATCH / d_ms * 1e3:.1f} "
        f"samples/s); losses card {['%.6f' % v for v in card[:3]]}... "
        f"CPU {['%.6f' % v for v in cpu[:3]]}..., worst relative gap "
        f"{rel:.3e} over {n} (limit {P23_WD_REL:g}); Distri against Local "
        f"{d_rel:.3e} (limit {P23_WD_DISTRI_REL:g}); example main "
        f"--distributed -e 2: train-set Top1 card {top1:.4f}, CPU "
        f"{top1_cpu:.4f} ({main_s:.1f} s on the card); {smi}")
    if len(card) != 1 + n or len(distri) != 1 + n or len(cpu) != n or \
            not all(np.isfinite(card + distri)):
        raise AssertionError("phase 23 (a): missing or non-finite losses")
    if not rel <= P23_WD_REL or not d_rel <= P23_WD_DISTRI_REL:
        raise AssertionError(f"phase 23 (a): losses off ({rel:.3e}, "
                             f"{d_rel:.3e})")
    if not abs(top1 - top1_cpu) <= P23_WD_TOP1_TOL:
        raise AssertionError(f"phase 23 (a): Top1 {top1} vs {top1_cpu}")


def _phase23_tree(smi: str) -> None:
    """(b): the tree-LSTM example on the card and on the CPU, and one
    step's launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.examples import train_tree_sentiment as X
    from bigdl_tpu_torch.nn import BinaryTreeLSTM

    steps = int(P23_TREE_ARGS[P23_TREE_ARGS.index("--max-steps") + 1])
    RandomGenerator.RNG.set_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses, acc = X.main(P23_TREE_ARGS + ["--device", DEV])
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3 / steps
    RandomGenerator.RNG.set_seed(0)
    t0 = time.perf_counter()
    cpu_losses, cpu_acc = X.main(P23_TREE_ARGS + ["--device", "cpu"])
    cpu_ms = (time.perf_counter() - t0) * 1e3 / steps
    # one training step of the example's shapes, its kernels counted
    emb, children, labels = X.synthetic_trees(128, 8, 16)
    m = BinaryTreeLSTM(16, 32).to(DEV)
    w = torch.zeros(32, 2, device=DEV, requires_grad=True)
    e = torch.from_numpy(emb).to(DEV)
    c = torch.from_numpy(children).to(DEV)
    yy = torch.from_numpy(labels.astype(np.int64) - 1).to(DEV)

    def step():
        h = m((e, c))
        loss = -torch.log_softmax(h[:, 0] @ w, -1).gather(
            1, yy[:, None]).mean()
        loss.backward()

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    launches = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA)
    step_ms = time_ms(step, reps=10)
    rel = max(abs(losses[k] - cpu_losses[k]) / abs(cpu_losses[k])
              for k in cpu_losses)
    say(f"phase 23 (b) tree-LSTM (batch 128, 8 leaves, embed 16, hidden "
        f"32, {steps} SGD steps): losses card "
        f"{['%.6f' % losses[k] for k in sorted(losses)]}, CPU "
        f"{['%.6f' % cpu_losses[k] for k in sorted(cpu_losses)]}, worst "
        f"relative gap {rel:.3e} (limit {P23_TREE_REL:g}); root accuracy "
        f"card {acc:.4f}, CPU {cpu_acc:.4f}; {card_ms:.3f} ms a step on the "
        f"card in main ({cpu_ms:.3f} on the CPU), a step alone "
        f"{step_ms:.3f} ms with {launches} kernels (launch-bound: the "
        f"eager loop over 15 nodes); {smi}")
    if sorted(losses) != sorted(cpu_losses) or len(losses) != steps // 50:
        raise AssertionError(f"phase 23 (b): losses at {sorted(losses)}")
    if not rel <= P23_TREE_REL or acc != cpu_acc:
        raise AssertionError(f"phase 23 (b): card off the CPU ({rel:.3e}, "
                             f"accuracy {acc} vs {cpu_acc})")


def _p23_alex_losses(device, x, y, steps, dropout):
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models import build_alexnet
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    RandomGenerator.RNG.set_seed(23)
    model = build_alexnet(1000, has_dropout=dropout)
    opt = LocalOptimizer(model, (x, y), ClassNLLCriterion(), len(x),
                         device=device)
    opt.set_optim_method(SGD(learningrate=P23_ALEX_LR))
    opt.set_end_when(Trigger.max_iteration(steps))
    losses = _TimedLosses()
    opt.set_train_summary(losses)
    return opt, losses


def _phase23_alexnet(smi: str) -> None:
    """(c): AlexNet-OWT in bf16 on the card, profiled; its first losses
    in f32 against the CPU's, TF32 on as the control."""
    rs = np.random.RandomState(23)
    x = rs.randn(P23_ALEX_BATCH, 3, P23_ALEX_IMG, P23_ALEX_IMG).astype(
        np.float32)
    y = (rs.randint(0, 1000, P23_ALEX_BATCH) + 1).astype(np.float32)
    torch.cuda.reset_peak_memory_stats()
    opt, losses = _p23_alex_losses(DEV, x, y, 1 + P23_ALEX_STEPS, True)
    opt.set_compute_dtype("bfloat16")
    opt.optimize()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_ms = _p23_step_ms(losses.at)
    bf16 = [losses.loss[k] for k in sorted(losses.loss)]
    phase_train_profile(opt, 23, "AlexNet-OWT bf16 step")
    del opt
    torch.cuda.empty_cache()
    xs, ys = x[:P23_ALEX_CPU_BATCH], y[:P23_ALEX_CPU_BATCH]

    def first(device):
        opt, ls = _p23_alex_losses(device, xs, ys, P23_ALEX_CPU_STEPS, False)
        opt.optimize()
        return [ls.loss[k] for k in sorted(ls.loss)]

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        card = first(DEV)
        with _tf32():
            tf32 = first(DEV)
    finally:
        torch.backends.cudnn.deterministic = det
    cpu = first("cpu")
    gap = max(abs(a - b) / abs(b) for a, b in zip(card, cpu))
    gap_tf32 = max(abs(a - b) / abs(b) for a, b in zip(tf32, cpu))
    say(f"phase 23 (c) AlexNet-OWT {P23_ALEX_IMG} px, batch "
        f"{P23_ALEX_BATCH}, bf16: losses {['%.4f' % v for v in bf16]}; step "
        f"{step_ms:.3f} ms ({P23_ALEX_BATCH / step_ms * 1e3:.1f} images/s), "
        f"peak memory {peak / 2 ** 30:.2f} GiB; f32 at batch "
        f"{P23_ALEX_CPU_BATCH}, cuDNN deterministic, TF32 off: card "
        f"{['%.6f' % v for v in card]}, CPU {['%.6f' % v for v in cpu]}, "
        f"worst relative gap {gap:.3e} (limit {P23_ALEX_CPU_TOL:g}); TF32 "
        f"on {gap_tf32:.3e} (the control); {smi}")
    if len(bf16) != 1 + P23_ALEX_STEPS or not all(np.isfinite(bf16)):
        raise AssertionError(f"phase 23 (c): losses {bf16}")
    if not gap <= P23_ALEX_CPU_TOL:
        raise AssertionError(f"phase 23 (c): card off the CPU by {gap:.3e}")
    if not gap_tf32 > P23_ALEX_CPU_TOL:
        raise AssertionError(f"phase 23 (c): the TF32 control reads "
                             f"{gap_tf32:.3e}, inside the limit: the limit "
                             "would not see a lower-precision conv")


def _p23_localize(cls, device, **kw):
    """LeNet-5 with ``nan_grad`` at step ``P23_NAN_STEP`` and the health
    monitor every ``P23_HEALTH_EVERY`` steps through ``cls``: (health
    steps, fetches, each report's layers with non-finite gradients, the
    counter's per-layer counts, the run's seconds)."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset.mnist import load_mnist, normalize
    from bigdl_tpu_torch.models.lenet import build_lenet5
    from bigdl_tpu_torch.nn import ClassNLLCriterion
    from bigdl_tpu_torch.obs import names
    from bigdl_tpu_torch.optim import SGD, Trigger
    from bigdl_tpu_torch.resilience.faults import reset_injector

    env = {"BIGDL_TORCH_HEALTH_EVERY": str(P23_HEALTH_EVERY),
           "BIGDL_TORCH_FAULT_PLAN": f"step:{P23_NAN_STEP}:nan_grad"}
    os.environ.update(env)
    reset_injector()
    obs.reset()
    try:
        RandomGenerator.RNG.set_seed(0)
        model = build_lenet5(device=device)
        x, y = load_mnist(None, "train", synthetic_n=P22_LENET_N)
        opt = cls(model, (normalize(x), y), ClassNLLCriterion(),
                  P22_LENET_BATCH, device=device, **kw)
        opt.set_optim_method(SGD(learningrate=0.1))
        opt.set_end_when(Trigger.max_iteration(P23_LENET_STEPS))
        summary = _P22Summary()
        opt.set_train_summary(summary)
        RandomGenerator.RNG.set_seed(1)
        t0 = time.perf_counter()
        opt.optimize()
        secs = time.perf_counter() - t0
        counts = {}
        for fam in obs.get_registry().families():
            if fam.name == names.NONFINITE_LAYERS_TOTAL:
                counts = {k[0]: c.value for k, c in fam.child_items()}
        bad = {s: [n for n, r in rows.items() if r["nonfinite"]]
               for s, rows in summary.health.items()}
        return (sorted(summary.health), opt._health_monitor.fetches, bad,
                counts, secs)
    finally:
        for k in env:
            os.environ.pop(k, None)
        reset_injector()
        obs.reset()


class _KeepNothing:
    """Stands in for ``obs.health.DeferredStats`` to run the code before
    the fix: a step off the cadence keeps no stats (None)."""

    def __new__(cls, fn):
        return None


def _p23_on_ab():
    """Phase 22 (a)'s "on" run (int8 + EF + buckets, health every 4,
    spans and the obs server) for ``P23_AB_STEPS`` steps, its steps
    alternating between the deferred stats and ``_KeepNothing`` (the
    code before the fix) a block of K steps at a time, each step timed
    from its dispatch to the card done with it.  Returns ({True: the
    steps' ms with, False: without}, the run's conv_bn launches); the
    first block is the warm-up."""
    import shutil
    import tempfile

    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs import health as H
    from bigdl_tpu_torch.obs import server
    from bigdl_tpu_torch.ops import _cuda

    x = np.random.RandomState(0).randn(
        TRAIN_BATCH, 3, TRAIN_IMG, TRAIN_IMG).astype(np.float32)
    y = (np.random.RandomState(1).randint(0, TRAIN_CLASSES, TRAIN_BATCH)
         + 1).astype(np.float32)
    real = H.DeferredStats
    before = dict(_cuda.launches)
    tmp = tempfile.mkdtemp(prefix="phase23_")
    env = {"BIGDL_TORCH_HEALTH_EVERY": str(P22_HEALTH_EVERY),
           "BIGDL_TORCH_OBS_PORT": "0",
           "BIGDL_TORCH_TRACE_DIR": os.path.join(tmp, "trace"),
           "BIGDL_TORCH_HANG_TIMEOUT": str(P22_HANG_S)}
    os.environ.update(env)
    ms = {True: [], False: []}
    try:
        from bigdl_tpu_torch.common import RandomGenerator
        from bigdl_tpu_torch.optim import Trigger

        model = _training_resnet50(True)
        RandomGenerator.RNG.set_seed(1)
        opt = _p22_trainer(model, x, y, wire_dtype="int8", wire_ef=True,
                           overlap_bucket_mb=P22_BUCKET_MB,
                           wire_block=P22_BLOCK)
        opt.set_end_when(Trigger.max_iteration(P23_AB_STEPS))
        step = opt._train_step

        def timed(*args):
            # blocks of K steps, one arm a block: a step's kept tensors
            # live into the next step, so a block's first step is not
            # counted, nor its K-th (both arms take the stats there)
            n = opt.state["neval"]
            block, at = divmod(n - 1, P22_HEALTH_EVERY)
            fixed = block % 2 == 1
            H.DeferredStats = real if fixed else _KeepNothing
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*args)
            torch.cuda.synchronize()
            if block > 0 and 0 < at < P22_HEALTH_EVERY - 1:
                ms[fixed].append((time.perf_counter() - t0) * 1e3)
            return out

        opt._train_step = timed
        opt.optimize()
        del opt, model
        torch.cuda.empty_cache()
    finally:
        H.DeferredStats = real
        for k in env:
            os.environ.pop(k, None)
        server.stop_server()
        obs.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    runs = {k: _cuda.launches[k] - before[k] for k in before}
    return ms, runs


def _phase23_health(smi: str):
    """(e): a tripped step off the health cadence localized on the card
    as on the CPU in both trainers; the "on" step before and after the
    fix.  Returns the timing runs' conv_bn launches."""
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.optim import DistriOptimizer, LocalOptimizer

    got = {}
    for name, cls, kw in (("LocalOptimizer", LocalOptimizer, {}),
                          ("DistriOptimizer", DistriOptimizer,
                           {"wire_dtype": "float32"})):
        for dev in (DEV, "cpu"):
            Engine.reset()
            if cls is DistriOptimizer:
                Engine.init(dev)
            got[name, dev] = _p23_localize(cls, dev, **kw)
        Engine.reset()
        card, cpu = got[name, DEV], got[name, "cpu"]
        want_steps = [P23_NAN_STEP, P23_HEALTH_EVERY]
        bad = card[2].get(P23_NAN_STEP, [])
        say(f"phase 23 (e) {name}: health reports at {card[0]}, {card[1]} "
            f"fetches; step {P23_NAN_STEP}'s offenders {len(bad)} "
            f"(first {bad[:1]}), the counter {sum(card[3].values()):.0f} "
            f"increments; CPU {cpu[0]}, {cpu[1]} fetches, the same "
            f"offenders: {card[2] == cpu[2] and card[3] == cpu[3]}; "
            f"{card[4] * 1e3 / P23_LENET_STEPS:.2f} ms a step on the card "
            f"(wall, first steps included)")
        if card[0] != want_steps or card[1] != 2 or not bad:
            raise AssertionError(f"phase 23 (e) {name}: {card[:3]}")
        if card[:4] != cpu[:4]:
            raise AssertionError(f"phase 23 (e) {name}: card {card[:4]} "
                                 f"vs CPU {cpu[:4]}")
    Engine.reset()
    Engine.init(DEV)
    try:
        groups, runs = _p23_on_ab()
    finally:
        Engine.reset()
    a, b = (np.asarray(groups[k]) for k in (True, False))
    on_ms, pre_ms = float(a.mean()), float(b.mean())
    se = float(np.sqrt(a.var(ddof=1) / a.size + b.var(ddof=1) / b.size))
    slack = max(P23_ON_SLOWER * pre_ms, 2 * se)
    say(f"phase 23 (e) phase 22 (a)'s 'on' step {on_ms:.3f} ms with the "
        f"deferred stats, {pre_ms:.3f} ms without them (the code before the "
        f"fix): means of {a.size} and {b.size} steps of one run in "
        f"alternate blocks of {P22_HEALTH_EVERY}, each from its dispatch "
        f"to the card done (medians {np.median(a):.3f} and "
        f"{np.median(b):.3f}); difference {on_ms - pre_ms:+.3f} ms, its "
        f"standard error {se:.3f} ms, limit +{slack:.3f} ms; {smi}")
    want = {"conv_bn_1x1": 36 * P23_AB_STEPS,
            "conv_bn_kxk": 16 * P23_AB_STEPS}
    if any(runs[k] != v for k, v in want.items()) or \
            any(v for k, v in runs.items() if k not in want):
        raise AssertionError(f"phase 23 (e): the timing run launched "
                             f"{runs}, want {want}")
    if not on_ms - pre_ms <= slack:
        raise AssertionError(f"phase 23 (e): the 'on' step got slower "
                             f"({on_ms:.3f} vs {pre_ms:.3f} ms)")
    return runs


def phase_item16(smi: str) -> None:
    """Phase 23: Wide & Deep at bench's widths, the tree-LSTM example and
    AlexNet-OWT trained on the card against the card machine's CPU, item
    16's layers card against CPU, and the health localization fix;
    callable alone after ``phase_device()``.  No ``csrc/`` kernel runs
    but in (e)'s rerun of phase 22 (a), whose launches are checked
    there."""
    from bigdl_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    kernels_before = _model_launches()
    parts = {}
    rerun = {}
    det = torch.backends.cudnn.deterministic
    for part, run in (("a", _phase23_wide_deep), ("b", _phase23_tree),
                      ("c", _phase23_alexnet)):
        t0 = time.perf_counter()
        run(smi)
        parts[part] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        _phase23_cases()
        parts["d"] = round(time.perf_counter() - t0, 1)
    finally:
        torch.backends.cudnn.deterministic = det
    t0 = time.perf_counter()
    rerun = _phase23_health(smi)
    parts["e"] = round(time.perf_counter() - t0, 1)
    moved = {k: _cuda.launches[k] - kernels_before[k] - rerun.get(k, 0)
             for k in kernels_before}
    if any(moved.values()):
        raise AssertionError(f"phase 23 launched a kernel of csrc/: {moved}")
    say(f"phase 23 (f) no csrc/ kernel launched in (a)-(e) but in (e)'s "
        f"run of phase 22 (a)'s path ({rerun})")
    print(smi, flush=True)
    say(f"phase 23 took {time.perf_counter() - t_phase:.1f} s (seconds by "
        f"part {parts})")


# ---------------------------------------------------------------- phase 24
def _p24_offset_case(tq, tk, off, dt, gen) -> list:
    """Rows 1-3 at query offset ``off`` against their plain versions
    (and the forward against ``_reference_attention``): the max abs
    errors of o, o against the reference, dq, dk, dv."""
    from bigdl_tpu_torch.ops.attention import (_reference_attention,
                                               flash_attention,
                                               flash_attention_plain,
                                               flash_backward,
                                               flash_bwd_dkv_plain,
                                               flash_bwd_dq_plain)

    b, h, d = P24_B, P24_H, P24_D
    scale = d ** -0.5
    q, g = (torch.randn((b, h, tq, d), generator=gen, device=DEV).to(dt)
            for _ in range(2))
    k, v = (torch.randn((b, h, tk, d), generator=gen, device=DEV).to(dt)
            for _ in range(2))
    out, lse = flash_attention(q, k, v, causal=True, seq_offset=off,
                               with_lse=True)
    flat = [x.reshape(b * h, -1, d) for x in (q, k, v, g)]
    o = out.reshape(b * h, tq, d)
    name = (f"Tq={tq} Tk={tk} offset={off} {str(dt)[6:]}")
    ref, ref_lse = flash_attention_plain(*flat[:3], causal=True, scale=scale,
                                         seq_offset=off)
    full = _reference_attention(*flat[:3], causal=True, scale=scale,
                                seq_offset=off)
    tol = (F32_TOL if dt == torch.float32
           else _bf16_ulp(ref.float().abs().max().item()))
    errs = [(o.float() - ref.float()).abs().max().item(),
            (o.float() - full.float()).abs().max().item()]
    check(f"phase 24 (a) flash_fwd {name}", errs[0], tol)
    check(f"phase 24 (a) flash_fwd {name} against the reference", errs[1],
          tol)
    check(f"phase 24 (a) flash_fwd {name} lse",
          (lse - ref_lse).abs().max().item(), F32_TOL)
    got = flash_backward(*flat[:3], o, lse, flat[3], causal=True,
                         scale=scale, seq_offset=off)
    delta = (flat[3].float() * o.float()).sum(dim=-1)
    want = (flash_bwd_dq_plain(*flat, lse, delta, causal=True, scale=scale,
                               seq_offset=off),
            *flash_bwd_dkv_plain(*flat, lse, delta, causal=True,
                                 scale=scale, seq_offset=off))
    for which, x, w in zip(("dq", "dk", "dv"), got, want):
        err = (x.float() - w.float()).abs().max().item()
        check(f"phase 24 (a) {which} {name}", err, _bwd_limit(w))
        errs.append(err)
    return errs


def _p24_offset_times(gen) -> dict:
    """Each of rows 1-3 at (Tq, Tk) = ``P24_TIMED`` in bf16 at the offsets
    of ``P24_TIMED_OFFSETS``: ms a call and on the device, and the bound
    from the (q, k) pairs the causal mask keeps at that offset and the
    keys it lets any query reach (dkv still writes every dK and dV
    row)."""
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.ops.attention import _flash_forward

    b, h, d = P24_B, P24_H, P24_D
    tq, tk = P24_TIMED
    dt, bh = torch.bfloat16, P24_B * P24_H
    q, g = (torch.randn((bh, tq, d), generator=gen, device=DEV).to(dt)
            for _ in range(2))
    k, v = (torch.randn((bh, tk, d), generator=gen, device=DEV).to(dt)
            for _ in range(2))
    item, rows = q.element_size(), 2 * bh * tq * 4
    out = {}
    for off in P24_TIMED_OFFSETS:
        o, lse = _flash_forward(q, k, v, causal=True, scale=d ** -0.5,
                                with_lse=True, seq_offset=off)
        delta = (g.float() * o.float()).sum(dim=-1)
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        kw = dict(causal=True, scale=d ** -0.5, seq_offset=off)
        pairs = bh * sum(min(tk, off + i + 1) for i in range(tq))
        reach = min(tk, off + tq)
        calls = {
            "flash_fwd": (lambda: _cuda.launch_flash_fwd(q, k, v, o, lse,
                                                         **kw),
                          (2 * tq + 2 * reach) * bh * d * item + bh * tq * 4,
                          4 * d * pairs),
            "flash_bwd_dq": (lambda: _cuda.launch_flash_bwd_dq(
                q, k, v, g, lse, delta, dq, **kw),
                (3 * tq + 2 * reach) * bh * d * item + rows, 6 * d * pairs),
            "flash_bwd_dkv": (lambda: _cuda.launch_flash_bwd_dkv(
                q, k, v, g, lse, delta, dk, dv, **kw),
                (2 * tq + 2 * reach + 2 * tk) * bh * d * item + rows,
                8 * d * pairs)}
        for name, (fn, nbytes, flops) in calls.items():
            ms, dev_ms = time_ms(fn), time_ms(fn, device_only=True)
            bms, by = bound(nbytes, flops, dt)
            out[name, off] = dict(ms=ms, device_ms=dev_ms, bound_ms=bms,
                                  bound_by=by)
            say(f"phase 24 (a) {name} B={b} H={h} Tq={tq} Tk={tk} D={d} "
                f"bf16 offset {off}: {ms:.4f} ms a call, {dev_ms:.4f} ms on "
                f"the device, bound {bms:.5f} ms ({by}, {pairs} causal "
                f"pairs), {bms / dev_ms:.3f} of it")
    return out


def phase24_offsets(gen) -> dict:
    """(a): every offset case in f32 and bf16, then the times; returns
    {kernel: its kernels-line additions}."""
    worst = {}
    n = 0
    for dt in (torch.float32, torch.bfloat16):
        for tq, tk in P24_SHAPES:
            for off in dict.fromkeys((0, 37, 64, tk - tq)):
                errs = _p24_offset_case(tq, tk, off, dt, gen)
                n += 1
                for key, e in zip(("fwd", "ref", "dq", "dk", "dv"), errs):
                    worst[key, dt] = max(worst.get((key, dt), 0.0), e)
    for dt in (torch.float32, torch.bfloat16):
        say(f"phase 24 (a) {str(dt)[6:]}: worst max abs err over the "
            f"offset cases: o {worst['fwd', dt]:.3e} (against the reference "
            f"{worst['ref', dt]:.3e}), dq {worst['dq', dt]:.3e}, dk "
            f"{worst['dk', dt]:.3e}, dv {worst['dv', dt]:.3e}")
    say(f"phase 24 (a) {n} offset cases within phase 3's and 10's limits")
    times = _p24_offset_times(gen)
    errs = {"flash_fwd": ("fwd",), "flash_bwd_dq": ("dq",),
            "flash_bwd_dkv": ("dk", "dv")}
    tq, tk = P24_TIMED
    rows = {}
    for name, keys in errs.items():
        row = {"offset_shape": f"B={P24_B} H={P24_H} Tq={tq} Tk={tk} "
                               f"D={P24_D} bf16 causal",
               "offset_max_abs_err": max(worst[k, torch.float32]
                                         for k in keys),
               "offset_max_abs_err_bf16": max(worst[k, torch.bfloat16]
                                              for k in keys)}
        for off in P24_TIMED_OFFSETS:
            t = times[name, off]
            row[f"offset{off}_ms"] = t["ms"]
            row[f"offset{off}_device_ms"] = t["device_ms"]
            row[f"offset{off}_bound_ms"] = t["bound_ms"]
        rows[name] = row
    return rows


_P24_TUNER_ENV = ("BIGDL_TORCH_TUNER", "BIGDL_TORCH_TUNER_MEASURE",
                  "BIGDL_TORCH_TUNER_CACHE")


def _no_grad(fn):
    with torch.no_grad():
        return fn()


def _p24_prewarms() -> list:
    """(site, the impl="auto" call of each shape of (b))."""
    from bigdl_tpu_torch.ops import autotune as TT

    calls = [("attn", lambda: TT.prewarm_attention(
        LM_BATCH, 8, LM_T, LM_T, 64, "bfloat16", device=DEV)),
        ("attn", lambda: TT.prewarm_attention(
            LONG_BATCH, 8, LONG_T, LONG_T, 64, "bfloat16", device=DEV))]
    for xs, ws, stride, pad in P24_CONV_SITES:
        calls.append(("conv_bn", lambda xs=xs, ws=ws, stride=stride,
                      pad=pad: TT.prewarm_conv_bn(
                          *xs, ws[0], ws[2], stride=stride, pad=pad,
                          dtype="bfloat16", device=DEV)))
    xs, ws, stride, pad = P24_CONV_SITES[1]
    calls += [
        ("attn", lambda: _no_grad(lambda: TT.prewarm_attention(
            1, 8, P24_NO_GRAD_PREFILL_T, P24_NO_GRAD_PREFILL_T, 64,
            "bfloat16", device=DEV))),
        ("conv_bn", lambda: _no_grad(lambda: TT.prewarm_conv_bn(
            P24_NO_GRAD_CONV_N, *xs[1:], ws[0], ws[2], stride=stride,
            pad=pad, dtype="bfloat16", device=DEV)))]
    dc = P24_DECODE
    calls.append(("decode_attn", lambda: TT.prewarm_decode_attn(
        dc["b"], dc["h"], dc["d"], page_size=dc["page_size"],
        maxp=dc["maxp"], dtype="float32", device=DEV)))
    for _, (m, k, n) in INT8_MM_SHAPES:
        calls.append(("int8_mm", lambda m=m, k=k, n=n: TT.prewarm_int8_mm(
            m, k, n, dtype="float32", device=DEV)))
    return calls


def phase24_tuner(tmp: str, smi: str) -> str:
    """(b): the tuner measures every shape into a fresh cache; a second
    pass after ``reset()`` is all hits with no measurement; a corrupt
    file gives the static choices and stays as it was.  Leaves the tuner
    off; returns the cache's path."""
    from bigdl_tpu_torch.obs import regress
    from bigdl_tpu_torch.ops import autotune as TT

    path = os.path.join(tmp, "tuner.json")
    os.environ.update({"BIGDL_TORCH_TUNER": "1",
                       "BIGDL_TORCH_TUNER_MEASURE": "1",
                       "BIGDL_TORCH_TUNER_CACHE": path})
    measure, emit = TT._measure, TT._emit
    counts = {"measured": 0}
    emitted = []

    def counting(*a, **kw):
        counts["measured"] += 1
        return measure(*a, **kw)

    def recording(site, rec, source):
        emitted.append((site, rec, source))
        return emit(site, rec, source)

    TT._measure, TT._emit = counting, recording
    try:
        TT.reset()
        calls = _p24_prewarms()
        t0 = time.perf_counter()
        for _, call in calls:
            call()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        decisions = TT.get_cache().decisions
        if len(decisions) != len(calls):
            raise AssertionError(f"phase 24 (b): {len(decisions)} decisions "
                                 f"for {len(calls)} shapes")
        tol = regress._default_tolerance()
        for key, rec in decisions.items():
            ms = {c: s * 1e3 for c, s in rec["measured_s"].items()}
            win, static = rec["label"], rec["static"]
            gate = rec.get("gate") or {}
            say(f"phase 24 (b) {rec['site']} {key}: measured ms "
                f"{ {c: round(v, 4) for c, v in ms.items()} }; static "
                f"{static}, winner {win} ({rec['source']}); regress "
                f"{gate.get('status', 'not needed (static kept)')}"
                f"{'' if not gate else ', ratio ' + str(gate.get('ratio'))}")
            if rec["source"] != "measured" or static not in ms:
                raise AssertionError(f"phase 24 (b) {key}: not measured")
            if win != static and not ms[win] < (
                    1 - TT._MEASURE_MARGIN) * ms[static]:
                raise AssertionError(f"phase 24 (b) {key}: winner {win} "
                                     f"{ms[win]:.4f} ms inside the tie "
                                     f"margin of static {static}'s "
                                     f"{ms[static]:.4f}")
            if not ms[win] <= ms[static] * tol:
                raise AssertionError(f"phase 24 (b) {key}: winner {win} "
                                     f"{ms[win]:.4f} ms over static "
                                     f"{static}'s {ms[static]:.4f} x {tol}")
        say(f"phase 24 (b) first pass: {len(decisions)} decisions, "
            f"{counts['measured']} candidates measured in {first_s:.1f} s; "
            f"{smi}")
        # a fresh cache object on the same file: all hits, no measurement
        TT.reset()
        counts["measured"] = 0
        for _, call in calls:
            call()
        stats = TT.get_cache().stats()
        say(f"phase 24 (b) second pass after reset(): {stats['hits']} hits, "
            f"{stats['misses']} misses, {counts['measured']} measurements")
        if stats["hits"] != len(calls) or stats["misses"] or \
                counts["measured"]:
            raise AssertionError(f"phase 24 (b) second pass: {stats}, "
                                 f"{counts['measured']} measurements")
        # a corrupt file: the static choice everywhere, the file untouched
        bad = os.path.join(tmp, "corrupt.json")
        with open(bad, "w") as f:
            f.write("{torn tuner cache")
        os.environ["BIGDL_TORCH_TUNER_CACHE"] = bad
        TT.reset()
        del emitted[:]
        for _, call in calls:
            call()
        with open(bad) as f:
            kept = f.read() == "{torn tuner cache"
        wrong = [(site, rec.get("label"), rec.get("static"))
                 for site, rec, src in emitted
                 if src != "corrupt_cache" or rec["label"] != rec["static"]]
        say(f"phase 24 (b) corrupt cache: {len(emitted)} decisions, all "
            f"static: {not wrong}; the file as it was: {kept}")
        if wrong or len(emitted) != len(calls) or not kept:
            raise AssertionError(f"phase 24 (b) corrupt cache: {wrong}, "
                                 f"{len(emitted)}, kept {kept}")
    finally:
        TT._measure, TT._emit = measure, emit
        for k in _P24_TUNER_ENV:
            os.environ.pop(k, None)
        TT.reset()
    return path


def _p24_tuner_env(on: bool, cache: str) -> None:
    if on:
        os.environ.update({"BIGDL_TORCH_TUNER": "1",
                           "BIGDL_TORCH_TUNER_CACHE": cache})
    else:
        for k in _P24_TUNER_ENV:
            os.environ.pop(k, None)


def _p24_lm_way(attention: str, tuner: bool, cache: str) -> dict:
    """One way of (c): ``train_long_lm.main`` for ``P24_STEPS`` steps
    from seed 0; losses, step ms (the median of steps 2 on), tokens/s,
    peak memory and rows 1-3's launches a step."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.examples import train_long_lm
    from bigdl_tpu_torch.ops import _cuda

    _p24_tuner_env(tuner, cache)
    try:
        RandomGenerator.RNG.set_seed(0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        hist = {}
        train_long_lm.main(P24_LM + ["--attention", attention, "--steps",
                                     str(P24_STEPS)], device=DEV,
                           history=hist)
        launches = tuple(_cuda.launches[k] // P24_STEPS for k in
                         ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
        ms = float(np.median(hist["seconds"][1:])) * 1e3
        out = dict(losses=hist["losses"], ms=ms,
                   tokens=LONG_BATCH * LONG_T / ms * 1e3,
                   peak=torch.cuda.max_memory_allocated() / 2 ** 30,
                   launches=launches)
        del hist
    finally:
        _p24_tuner_env(False, cache)
    torch.cuda.empty_cache()
    return out


def _p24_lm_ab(cache: str) -> dict:
    """The tuner on and off in alternate blocks of ``P24_AB_BLOCK`` steps
    of one Ulysses run (the first block a warm-up, each block's first
    step not counted): {True: on ms, False: off ms}."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.examples import train_long_lm

    RandomGenerator.RNG.set_seed(0)
    run = train_long_lm.LongLMRun(train_long_lm.parse_args(
        P24_LM + ["--attention", "ulysses"]), DEV)
    ms = {True: [], False: []}
    try:
        for block in range(P24_AB_BLOCKS):
            on = block % 2 == 1
            _p24_tuner_env(on, cache)
            for i in range(P24_AB_BLOCK):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run.step()
                if block > 0 and i > 0:
                    ms[on].append((time.perf_counter() - t0) * 1e3)
    finally:
        _p24_tuner_env(False, cache)
    del run
    torch.cuda.empty_cache()
    return ms


def phase24_long_lm(cache: str, smi: str) -> None:
    """(c): the long-context LM three ways, then the on/off A/B."""
    from bigdl_tpu_torch.ops import autotune as TT

    key = TT.cache_key("attn", f"b{LONG_BATCH}h8tq{LONG_T}tk{LONG_T}d64",
                       torch.bfloat16, TT.platform(DEV), extra="c1o0")
    _p24_tuner_env(True, cache)
    TT.reset()
    arm = TT.get_cache().decisions[key]["impl"]
    _p24_tuner_env(False, cache)
    ways = {}
    for label, attention, tuner in (("plain", "plain", False),
                                    ("ulysses, tuner off", "ulysses", False),
                                    ("ulysses, tuner on", "ulysses", True)):
        w = _p24_lm_way(attention, tuner, cache)
        ways[label] = w
        say(f"phase 24 (c) {label}: losses "
            f"{['%.5f' % x for x in w['losses']]}; step {w['ms']:.3f} ms "
            f"(median of steps 2-{P24_STEPS}), {w['tokens']:.1f} tokens/s, "
            f"peak memory {w['peak']:.2f} GiB; rows 1-3 a step "
            f"{w['launches']}")
    gaps = [abs(a - b) for a, b in zip(ways["plain"]["losses"],
                                       ways["ulysses, tuner off"]["losses"])]
    on_gaps = [abs(a - b) for a, b in zip(
        ways["ulysses, tuner on"]["losses"],
        ways["ulysses, tuner off"]["losses"])]
    want = (16, 8, 8) if arm == "kernel" else (0, 0, 0)
    say(f"phase 24 (c) the tuner's arm at B={LONG_BATCH} T={LONG_T}: {arm}; "
        f"|plain - ulysses off| by step {['%.3e' % g for g in gaps]} (limit "
        f"{LM_LOSS_TOL:g}); |on - off| {['%.3e' % g for g in on_gaps]}; "
        f"launches a step {ways['ulysses, tuner on']['launches']} (want "
        f"{want}); {smi}")
    if not all(g <= LM_LOSS_TOL for g in gaps):
        raise AssertionError("phase 24 (c): plain and Ulysses losses differ")
    if ways["ulysses, tuner on"]["launches"] != want or \
            ways["ulysses, tuner off"]["launches"] != (0, 0, 0):
        raise AssertionError(f"phase 24 (c): launches {ways}")
    ab = _p24_lm_ab(cache)
    a, b = (np.asarray(ab[k]) for k in (True, False))
    ratio = a.mean() / b.mean()
    se = ratio * float(np.sqrt(a.var(ddof=1) / a.size / a.mean() ** 2
                               + b.var(ddof=1) / b.size / b.mean() ** 2))
    say(f"phase 24 (c) A/B in one run, alternate blocks of {P24_AB_BLOCK} "
        f"steps: tuner on {a.mean():.3f} ms (median {np.median(a):.3f}, "
        f"{a.size} steps), off {b.mean():.3f} ms (median {np.median(b):.3f}, "
        f"{b.size} steps); on/off {ratio:.4f} +- {2 * se:.4f} (two standard "
        f"errors); {smi}")


def phase24_ring() -> None:
    """(d): ``RingMultiHeadAttention`` at world 1 against the plain
    module on the same weights and inputs, f32, T=``LONG_T``."""
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.nn.attention import MultiHeadAttention
    from bigdl_tpu_torch.parallel import RingMultiHeadAttention

    mesh = Engine.build_mesh({"seq": 1})
    RandomGenerator.RNG.set_seed(2)
    plain = MultiHeadAttention(512, 8, causal=True,
                               attn_impl="reference").to(DEV)
    ring = RingMultiHeadAttention(512, 8, mesh, causal=True).to(DEV)
    ring.set_params(plain.params())
    gen = torch.Generator(device=DEV)
    gen.manual_seed(3)
    x = torch.randn((LONG_BATCH, LONG_T, 512), generator=gen, device=DEV)
    outs, grads = [], []
    for m in (plain, ring):
        xi = x.clone().requires_grad_(True)
        y = m(xi)
        grads.append(torch.autograd.grad(y.square().sum(), xi)[0])
        outs.append(y.detach())
    err = (outs[0] - outs[1]).abs().max().item()
    gerr = ((grads[0] - grads[1]).abs().max()
            / grads[0].abs().max()).item()
    say(f"phase 24 (d) {ring!r} at world 1, B={LONG_BATCH} T={LONG_T} f32: "
        f"max abs err {err:.3e} against MultiHeadAttention (limit "
        f"{F32_TOL:g}); input gradient {gerr:.3e} of its largest (limit "
        f"{F32_TOL:g})")
    check("phase 24 (d) ring module", err, F32_TOL)
    check("phase 24 (d) ring module input gradient", gerr, F32_TOL)


def phase_seq_tuner(smi: str) -> dict:
    """Phase 24: (a) rows 1-3 at a query offset, (b) the tuner measured,
    (c) the long-context LM through Ulysses three ways and the tuner's
    A/B, (d) the ring module; callable alone after ``phase_device()``
    (the kernels build at first launch).  Returns rows 1-3's
    kernels-line additions."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.engine import Engine

    t_phase = time.perf_counter()
    parts = {}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(24)
    t0 = time.perf_counter()
    rows = phase24_offsets(gen)
    parts["a"] = round(time.perf_counter() - t0, 1)
    tmp = tempfile.mkdtemp(prefix="phase24_")
    Engine.reset()
    Engine.init(DEV)
    try:
        t0 = time.perf_counter()
        cache = phase24_tuner(tmp, smi)
        parts["b"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        phase24_long_lm(cache, smi)
        parts["c"] = round(time.perf_counter() - t0, 1)
        t0 = time.perf_counter()
        phase24_ring()
        parts["d"] = round(time.perf_counter() - t0, 1)
    finally:
        Engine.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(smi, flush=True)
    say(f"phase 24 took {time.perf_counter() - t_phase:.1f} s (seconds by "
        f"part {parts})")
    return rows

# ---- phase 25: tensor parallelism, TP decode, the pipeline and MoE ---------
TP_WORLD = 2
TP_LM_BATCH, TP_LM_T = 4, 512
MOE_CFG = dict(dim=512, hidden=2048, n_experts=8, top_k=2,
               capacity_factor=1.25)
MOE_BATCH, MOE_T = 8, 512
MOE_TOL = 1e-4
PIPE_STAGE_M, PIPE_STAGE_MB = 6, 8


def _tp_rank_main(args) -> int:
    """One rank of phase 25 (a): ``chip_smoke.py --tp-rank RANK STORE
    OUT``.  Joins a gloo world of ``TP_WORLD`` over the ``FileStore``
    STORE on the one card, builds the ``{"model": TP_WORLD}`` mesh and
    the flagship's ``LMEngine(tp=TP_WORLD)`` (the kernels phase 2
    built are loaded, not built), then leads phase 4's traffic (rank 0)
    or follows it; writes its tokens, stats, wire bytes and launches
    to the JSON file OUT."""
    import torch.distributed as dist

    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.ops import _cuda

    rank, store, out = int(args[0]), args[1], args[2]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, TP_WORLD),
                            rank=rank, world_size=TP_WORLD)
    Engine.init(DEV)
    Engine.build_mesh({"model": TP_WORLD})
    eng = _lm_engine(_flagship(0), tp=TP_WORLD)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    res = {}
    if rank == 0:
        t0 = time.perf_counter()
        reqs = [eng.submit(p, SERVE_NEW_TOKENS) for p in _serving_prompts()]
        eng.run_until_idle(600)
        torch.cuda.synchronize()
        res["wall_s"] = time.perf_counter() - t0
        res["tokens"] = [r.tokens for r in reqs]
        res["errors"] = [r.error for r in reqs]
        fam = obs.get_registry().counter("bigdl_collective_bytes_total",
                                         labels=("op", "dtype"))
        res["psum_bytes"] = fam.labels(op="serve_tp_psum",
                                       dtype="float32").value
    else:
        eng.follow()
        torch.cuda.synchronize()
    st = eng.stats()
    eng.close()
    res["stats"] = {k: st[k] for k in ("steps", "tokens", "tokens_per_s",
                                       "decode_ms_mean", "ttft_p50_s",
                                       "preemptions")}
    res["launches"] = dict(_cuda.launches)
    with open(out, "w") as f:
        json.dump(res, f)
    Engine.reset()
    dist.destroy_process_group()
    return 0


def _phase25_decode_kernel(gen) -> dict:
    """(a) row 6 at a TP rank's local heads: the kernel against its
    plain version, run twice bit-equal, timed beside its bound."""
    from bigdl_tpu_torch.ops.decode_attention import (decode_splits,
                                                      paged_decode,
                                                      paged_decode_plain)

    h = LM["n_head"] // TP_WORLD
    q, kp, vp, tables, lengths = _decode_state(gen, torch.float32,
                                               torch.float32, h=h)
    out = paged_decode(q, kp, vp, tables, lengths, page_size=16)
    again = paged_decode(q, kp, vp, tables, lengths, page_size=16)
    torch.cuda.synchronize()
    b, _, d = q.shape
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    splits = decode_splits(b, h, tables.shape[1], sms)
    label = (f"paged_decode B={b} H={h} Dh={d} P=16 f32 bucket "
             f"{tables.shape[1]} ({splits} splits)")
    if not torch.equal(out, again):
        raise AssertionError(f"phase 25 (a) {label}: two runs differ")
    ref = paged_decode_plain(q, kp, vp, tables, lengths, page_size=16,
                             scale=d ** -0.5)
    err = (out - ref).abs().max().item()
    check(f"phase 25 (a) {label}", err, F32_TOL)

    def kernel():
        paged_decode(q, kp, vp, tables, lengths, page_size=16)

    ms = time_ms(kernel)
    device_ms = time_ms(kernel, device_only=True)
    plain = time_ms(lambda: paged_decode_plain(
        q, kp, vp, tables, lengths, page_size=16, scale=d ** -0.5))
    positions = int((lengths + 1).sum())
    pages = int((lengths // 16 + 1).sum())
    nbytes = (2 * b * h * d * 4 + 2 * positions * h * d * 4
              + pages * 4 + b * 4)
    b_ms, b_by = bound(nbytes, 4 * h * d * positions, torch.float32)
    say(f"phase 25 (a) {label}: max abs err {err:.3e} (limit {F32_TOL:g}), "
        f"bit-equal run to run; kernel {ms:.4f} ms a call, {device_ms:.4f} "
        f"ms on the device ({b_ms / device_ms:.3f} of the bound), plain "
        f"{plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(tp_shape=f"B={b} H={h} Dh={d} P=16 f32, {splits} splits",
                tp_max_abs_err=err, tp_ms=ms, tp_device_ms=device_ms,
                tp_plain_ms=plain, tp_bound_ms=b_ms, tp_bound_by=b_by)


def _phase25_ranks(tmp: str) -> list:
    """(a) the two rank processes; each one's JSON record."""
    root = os.path.dirname(os.path.abspath(__file__))
    store = os.path.join(tmp, "store")
    outs = [os.path.join(tmp, f"rank{r}.json") for r in range(TP_WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         store, outs[r]], cwd=root, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(TP_WORLD)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 25 (a) rank {r} exited "
                                 f"{p.returncode}: {log[-4000:]}")
    recs = []
    for o in outs:
        with open(o) as f:
            recs.append(json.load(f))
    return recs


def _phase25_tp_decode(recs, p4_stats, smi) -> dict:
    """(a) the served tokens against a dense forward and phase 4's, the
    launches and the wire bytes; the kernels line's additions."""
    from bigdl_tpu_torch.obs import collectives as C

    lead = recs[0]
    prompts = _serving_prompts()
    if any(lead["errors"]) or any(len(t) != SERVE_NEW_TOKENS
                                  for t in lead["tokens"]):
        raise AssertionError("phase 25 (a): a request failed or came back "
                             "short")
    model = _flagship(0)
    gap = _top_logit_gap(model, prompts, lead["tokens"])
    del model
    exact = sum(a == b for a, b in zip(lead["tokens"], _P4_TOKENS))
    steps = [r["stats"]["steps"] for r in recs]
    dec = [r["launches"]["paged_decode"] for r in recs]
    pre = [r["launches"]["flash_fwd"] for r in recs]
    want_bytes = (C.all_reduce_bytes(SERVE_MAX_BATCH * LM["dim"],
                                     "float32", TP_WORLD)
                  * 2 * LM["n_layer"])
    st = lead["stats"]
    say(f"phase 25 (a) LMEngine(tp={TP_WORLD}) over gloo, two ranks on one "
        f"card: {st['tokens']} tokens in {lead['wall_s']:.3f} s, steps "
        f"{steps}, preemptions {st['preemptions']}; tokens/s "
        f"{st['tokens_per_s']:.1f} (phase 4 at tp=1: "
        f"{p4_stats['tokens_per_s']:.1f}), decode step "
        f"{st['decode_ms_mean']:.3f} ms mean (phase 4: "
        f"{p4_stats['decode_ms_mean']:.3f}), ttft p50 "
        f"{st['ttft_p50_s'] * 1e3:.2f} ms; {smi}")
    say(f"phase 25 (a) check: worst (top logit - served token's logit) "
        f"{gap:.3e} (limit 1e-3); exact match with phase 4's tokens "
        f"{exact}/{len(prompts)} requests; launches by rank: paged_decode "
        f"{dec}, flash_fwd {pre}; serve_tp_psum {lead['psum_bytes']:.0f} "
        f"bytes a step (formula {want_bytes:.0f})")
    if gap > 1e-3:
        raise AssertionError(f"phase 25 (a): a served token is off the top "
                             f"logit by {gap}")
    if steps[0] != steps[1] or any(
            n != LM["n_layer"] * s for n, s in zip(dec, steps)):
        raise AssertionError(f"phase 25 (a): paged_decode launches {dec} "
                             f"for steps {steps}")
    if min(pre) <= 0:
        raise AssertionError(f"phase 25 (a): flash_fwd launches {pre}")
    if lead["psum_bytes"] != want_bytes:
        raise AssertionError(f"phase 25 (a): serve_tp_psum "
                             f"{lead['psum_bytes']} != {want_bytes}")
    return {"flash_fwd": {"tp_launches": pre},
            "paged_decode": {"tp_launches": dec}}


def _phase25_tp_lm(smi) -> dict:
    """(b) the flagship's TP forward and backward over ``shard_params``
    at world 1 against the dense model; rows 1-3's launches."""
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.parallel import shard_params
    from bigdl_tpu_torch.parallel.tensor_parallel import (_tree_map,
                                                          tp_lm_forward)

    mesh = Engine.build_mesh({"model": 1})
    model = _flagship(0)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(25)
    tokens = torch.randint(0, 8192, (TP_LM_BATCH, TP_LM_T), generator=gen,
                           device=DEV)
    ct = torch.randn((TP_LM_BATCH, TP_LM_T, 8192), generator=gen, device=DEV)
    leaves = _tree_map(lambda t: t.detach().clone().requires_grad_(True),
                       shard_params(model.params(), mesh))
    names = [n for n, _ in model.named_parameters()]

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}.") if isinstance(v, dict)
                       else {f"{prefix}{k}": v})
        return out

    torch.cuda.synchronize()
    _cuda.reset_launches()
    out = tp_lm_forward(model, leaves, tokens, mesh)
    (out * ct).sum().backward()
    torch.cuda.synchronize()
    launches = {k: _cuda.launches[k]
                for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    dense = model(tokens)
    (dense * ct).sum().backward()
    err = ((out - dense).abs().max() / dense.abs().max()).item()
    tp_grads = flat(_tree_map(lambda t: t.grad, leaves))
    scale = max(p.grad.abs().max().item() for p in model.parameters())
    gerr = max((tp_grads[n] - p.grad).abs().max().item()
               for n, p in model.named_parameters()) / scale
    if set(tp_grads) != set(names):
        raise AssertionError("phase 25 (b): gradient trees differ")

    def tp_step():
        o = tp_lm_forward(model, leaves, tokens, mesh)
        torch.autograd.grad((o * ct).sum(), list(flat(leaves).values()))

    def dense_step():
        o = model(tokens)
        torch.autograd.grad((o * ct).sum(), list(model.parameters()))

    tp_ms = time_ms(tp_step, reps=5, warmup=1)
    dense_ms = time_ms(dense_step, reps=5, warmup=1)
    say(f"phase 25 (b) TP forward + backward of the flagship over "
        f"shard_params at world 1, B={TP_LM_BATCH} T={TP_LM_T} f32: logits "
        f"{err:.3e} of the largest, parameter gradients {gerr:.3e} of the "
        f"largest (limit {F32_TOL:g}); launches {launches}; {tp_ms:.3f} ms "
        f"a step (dense model {dense_ms:.3f} ms); {smi}")
    check("phase 25 (b) TP logits", err, F32_TOL)
    check("phase 25 (b) TP gradients", gerr, F32_TOL)
    if any(n != LM["n_layer"] for n in launches.values()):
        raise AssertionError(f"phase 25 (b): launches {launches}")
    return {k: {"tp_lm_launches": n} for k, n in launches.items()}


def _moe_by_index(m, x):
    """MoE's function with every token sent to its experts by index: the
    routing order of ``MoE`` (argmax, then argmax of the rest), each
    expert's kept tokens gathered, run through its FFN and added back
    weighted by their gate, top-2 renormalized by the kept gates."""
    s_, d = x.shape[0] * x.shape[1], x.shape[2]
    e, k = m.n_experts, m.top_k
    cap = max(1, int(np.ceil(m.capacity_factor * s_ * k / e)))
    xs = x.reshape(s_, d)
    probs = torch.softmax(xs @ m.gate, dim=-1)
    avail = probs.detach().clone()
    rows = torch.arange(s_, device=x.device)
    y = torch.zeros_like(xs)
    kept_gate = probs.new_zeros(s_)
    taken = [0] * e
    frac = probs.new_zeros(e)
    for _ in range(k):
        choice = avail.argmax(dim=-1)
        frac = frac + torch.bincount(choice, minlength=e).float() / s_
        for j in range(e):
            idx = (choice == j).nonzero()[:, 0]
            kept = idx[:max(0, cap - taken[j])]
            taken[j] += idx.numel()
            h = torch.relu(xs[kept] @ m.w_in[j] + m.b_in[j])
            gate = probs[kept, j]
            y = y.index_add(0, kept, (h @ m.w_out[j] + m.b_out[j])
                            * gate[:, None])
            kept_gate = kept_gate.index_add(0, kept, gate)
        avail[rows, choice] = 0.0
    if k > 1:
        y = y / kept_gate.clamp_min(1e-9)[:, None]
    aux = m.aux_loss_weight * e * torch.sum(frac / k * probs.mean(dim=0))
    return y.reshape(x.shape), aux


def _phase25_moe_pipe(smi) -> None:
    """(c) MoE against routing by index, and ``pipelined`` at world 1."""
    import copy

    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.parallel import MoE, pipelined

    RandomGenerator.RNG.set_seed(25)
    m = MoE(**MOE_CFG).to(DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(25)
    x = torch.randn((MOE_BATCH, MOE_T, MOE_CFG["dim"]), generator=gen,
                    device=DEV)
    names = ["input"] + [n for n, _ in m.named_parameters()]

    def compare(mod, xs):
        """(output gap, aux gap, each gradient's gap over its largest)
        of ``mod`` against routing by index, on ``xs``."""
        res = []
        for fn in (mod.forward_with_aux, lambda t: _moe_by_index(mod, t)):
            xi = xs.clone().requires_grad_(True)
            y, aux = fn(xi)
            grads = torch.autograd.grad(y.square().sum() + aux,
                                        [xi] + list(mod.parameters()))
            res.append((y.detach(), aux.item(), grads))
        (y, aux, g), (ry, raux, rg) = res
        gaps = {n: ((a - b).abs().max() / b.abs().max()).item()
                for n, a, b in zip(names, g, rg)}
        return (y - ry).abs().max().item(), abs(aux - raux), gaps, y

    err, aux_err, gaps32, y = compare(m, x)
    kept = int((y.abs().sum(-1) > 0).sum())
    # the gradients, gated in f64: in f32 the two orders of summation
    # put a few pre-activations on either side of the ReLU's kink, and
    # each such token moves its expert's gradient by its own share
    _, _, gaps64, _ = compare(copy.deepcopy(m).double(), x.double())
    params = list(m.parameters())

    def step():
        xi = x.clone().requires_grad_(True)
        yy, aa = m.forward_with_aux(xi)
        torch.autograd.grad(yy.square().sum() + aa, [xi] + params)

    ms = time_ms(step, reps=5, warmup=1)
    cap = int(np.ceil(MOE_CFG["capacity_factor"] * MOE_BATCH * MOE_T
                      * MOE_CFG["top_k"] / MOE_CFG["n_experts"]))
    fmt = lambda gaps: ", ".join(f"{n} {v:.3e}" for n, v in gaps.items())
    say(f"phase 25 (c) {m!r} B={MOE_BATCH} T={MOE_T} f32, capacity {cap}: "
        f"output {err:.3e} (limit {MOE_TOL:g}), aux loss {aux_err:.3e} "
        f"against routing by index; {kept}/{MOE_BATCH * MOE_T} tokens kept; "
        f"forward + backward {ms:.3f} ms; {smi}")
    say(f"phase 25 (c) gradients over their largest, f32 (not gated): "
        f"{fmt(gaps32)}; f64 (limit {MOE_TOL:g}): {fmt(gaps64)}")
    check("phase 25 (c) MoE output", err, MOE_TOL)
    check("phase 25 (c) MoE aux loss", aux_err, MOE_TOL)
    check("phase 25 (c) MoE gradients (f64)", max(gaps64.values()), MOE_TOL)

    mesh = Engine.build_mesh({"pipe": 1})
    d = LM["dim"]
    stacked = {"w": torch.randn((1, d, d), generator=gen, device=DEV)
               * d ** -0.5,
               "b": torch.randn((1, d), generator=gen, device=DEV) * 0.1}
    xp = torch.randn((PIPE_STAGE_M, PIPE_STAGE_MB, d), generator=gen,
                     device=DEV)
    out = pipelined(lambda p, a: torch.tanh(a @ p["w"] + p["b"]), mesh,
                    "pipe")(stacked, xp)
    ref = torch.tanh(xp @ stacked["w"][0] + stacked["b"][0])
    perr = (out - ref).abs().max().item()
    say(f"phase 25 (c) pipelined at world 1, M={PIPE_STAGE_M} "
        f"mb={PIPE_STAGE_MB} D={d}: {perr:.3e} against the stage in "
        f"sequence (limit {F32_TOL:g})")
    check("phase 25 (c) pipelined", perr, F32_TOL)


def phase_tp_moe(smi: str, p4_stats: dict) -> dict:
    """Phase 25: (a) TP decode on two ranks of the card, (b) the TP LM,
    (c) MoE and the pipeline; callable alone after ``phase_device()``,
    ``phase_build()`` and ``phase_main_path()``.  Returns rows 1-3's and
    6's kernels-line additions."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.engine import Engine

    t_phase = time.perf_counter()
    parts, rows = {}, {}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(25)
    t0 = time.perf_counter()
    rows["paged_decode"] = _phase25_decode_kernel(gen)
    tmp = tempfile.mkdtemp(prefix="phase25_")
    try:
        recs = _phase25_ranks(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for name, extra in _phase25_tp_decode(recs, p4_stats, smi).items():
        rows.setdefault(name, {}).update(extra)
    parts["a"] = round(time.perf_counter() - t0, 1)
    Engine.reset()
    Engine.init(DEV)
    try:
        t0 = time.perf_counter()
        for name, extra in _phase25_tp_lm(smi).items():
            rows.setdefault(name, {}).update(extra)
        parts["b"] = round(time.perf_counter() - t0, 1)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        _phase25_moe_pipe(smi)
        parts["c"] = round(time.perf_counter() - t0, 1)
    finally:
        Engine.reset()
    torch.cuda.empty_cache()
    print(smi, flush=True)
    say(f"phase 25 took {time.perf_counter() - t_phase:.1f} s (seconds by "
        f"part {parts})")
    return rows


# ---- phase 26: control flow and the model front ends -----------------------
# (a) VGG-16 (seed 0, LogSoftMax kept) through to_graph -> TensorflowSaver
# -> TensorflowLoader on the card: the forward at batch 8 against the
# exported graph's and at batch 2 against the card machine's CPU, at phase
# 16's limits; (b) TFTrainingSession fine-tunes the loaded graph through
# LocalOptimizer (ClassNLLCriterion, SGD 0.01 momentum 0.9, batch 32, 1 + 5
# steps, cuDNN deterministic) beside the source Sequential with its
# Dropout off (the frozen graph exports Dropout as Identity): each loss
# within P26_LOSS_TOL relative of the source's; (c) the weights as an
# nn.Sequential TorchObject tree through save_t7 -> load_t7 ->
# load_torch_module, batch 8; (d) VGG-16 as a Keras-1.2.2 JSON config,
# eval output against exp of the source's at batch 8, then compile("sgd",
# "categorical_crossentropy") and fit P26_KERAS_STEPS batches of 32;
# (e) a TF while frame and a Switch/Merge conditional at (64, 512) with a
# 512x512 weight, imported on the card and on the CPU: forward and input
# gradient within 1e-5 (relative to the largest); the DynamicGraph's
# forward at max_iterations 32 against a body that stops after 3, timed
# beside 3 plain iterations; (f) the three example scripts in child
# processes at their defaults, cut to 2 epochs
P26_FWD_BATCH, P26_CPU_BATCH, P26_BATCH, P26_STEPS = 8, 2, 32, 5
P26_LOSS_TOL, P26_T7_TOL, P26_KERAS_TOL, P26_FLOW_TOL = 1e-5, 1e-5, 1e-5, 1e-5
P26_KERAS_STEPS, P26_FLOW_N, P26_FLOW_D, P26_LOOP_MAX = 6, 64, 512, 32
P26_EXAMPLES = [("mnist_cnn", ["--nb-epoch", "2"]),
                ("finetune_frozen_graph", ["--max-epoch", "2"]),
                ("train_from_tf_pipeline", ["--max-epoch", "2"])]

_EXAMPLE_RUNNER = r"""
import importlib, json, math, sys
from bigdl_tpu_torch.optim import distri_optimizer as D, optimizer as O
losses = []


class Rec:
    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            losses.append(float(value))


for cls in (O.LocalOptimizer, D.DistriOptimizer):
    def optimize(self, _real=cls.optimize):
        if self.train_summary is None:
            self.set_train_summary(Rec())
        return _real(self)
    cls.optimize = optimize
out, name = sys.argv[1], sys.argv[2]
value = importlib.import_module("bigdl_tpu_torch.examples." + name).main(
    sys.argv[3:])
with open(out, "w") as f:
    json.dump({"value": value, "losses": losses}, f)
"""


class _P26Losses(_Losses):
    """Each step's loss and the wall clock when it was read."""

    def __init__(self):
        super().__init__()
        self.at = {}

    def add_scalar(self, tag, value, step):
        super().add_scalar(tag, value, step)
        if tag == "Loss":
            self.at[step] = time.perf_counter()


@contextlib.contextmanager
def _p26_recorded(rec):
    """Every ``LocalOptimizer`` made inside reports to ``rec``."""
    from bigdl_tpu_torch.optim import optimizer as O

    real = O.LocalOptimizer.optimize

    def optimize(self):
        if self.train_summary is None:
            self.set_train_summary(rec)
        return real(self)

    O.LocalOptimizer.optimize = optimize
    try:
        yield rec
    finally:
        O.LocalOptimizer.optimize = real


@contextlib.contextmanager
def _deterministic():
    b = torch.backends.cudnn
    was = (b.deterministic, b.benchmark)
    b.deterministic, b.benchmark = True, False
    try:
        yield
    finally:
        b.deterministic, b.benchmark = was


def _rel_gap(a, b) -> float:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return float((a - b).abs().max() / b.abs().max())


def _p26_images(n, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 3, CAFFE_IMG, CAFFE_IMG).astype(np.float32)
    y = (rs.randint(0, 1000, n) + 1).astype(np.float32)
    return x, y


def _p26_tf(model, tmp, smi):
    """(a): the TF round trip.  Returns the GraphDef's path."""
    from bigdl_tpu_torch.utils.tf_interop import (TensorflowLoader,
                                                  TensorflowSaver,
                                                  parse_graphdef)

    graph = model.to_graph().evaluate()
    path = os.path.join(tmp, "vgg16.pb")
    t0 = time.perf_counter()
    TensorflowSaver.save(graph, path)
    save_s = time.perf_counter() - t0
    with open(path, "rb") as f:
        n_nodes = len(parse_graphdef(f.read()))
    t0 = time.perf_counter()
    loaded = TensorflowLoader(path, device=DEV).load().evaluate()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = torch.randn(P26_FWD_BATCH, 3, CAFFE_IMG, CAFFE_IMG,
                    generator=torch.Generator().manual_seed(26)).to(DEV)
    with torch.no_grad():
        ref, y = graph(x), loaded(x)
        card = _rel_gap(y, ref)
        cpu_graph = TensorflowLoader(path, device="cpu").load().evaluate()
        xc = x[:P26_CPU_BATCH].cpu()
        yc = cpu_graph(xc)
        cpu = _rel_gap(y[:P26_CPU_BATCH], yc)
        with _tf32():
            tf32 = _rel_gap(loaded(x[:P26_CPU_BATCH]), yc)
    say(f"phase 26 (a) VGG-16 to_graph ({len(graph.topo_order())} nodes) "
        f"-> TensorflowSaver: {n_nodes} GraphDef nodes, "
        f"{os.path.getsize(path)} bytes in {save_s:.2f} s; "
        f"TensorflowLoader on the card {load_s:.2f} s "
        f"({len(loaded.topo_order())} nodes); forward at batch "
        f"{P26_FWD_BATCH} against the exported graph's, relative "
        f"{card:.3e} (limit {CAFFE_CARD_TOL:g}); against the CPU's at "
        f"batch {P26_CPU_BATCH} {cpu:.3e} (limit {CAFFE_CPU_TOL:g}); with "
        f"TF32 on (the control) {tf32:.3e}, "
        f"{'over' if tf32 > CAFFE_CPU_TOL else 'within'} the limit [{smi}]")
    if not card <= CAFFE_CARD_TOL or not cpu <= CAFFE_CPU_TOL:
        raise AssertionError("VGG-16: the loaded GraphDef off the exported "
                             "graph")
    if tuple(y.shape) != (P26_FWD_BATCH, 1000) or \
            not bool(torch.isfinite(y).all()):
        raise AssertionError(f"VGG-16 GraphDef forward {tuple(y.shape)}")
    return path


def _p26_t7(model, tmp, smi):
    """(c): the source's weights as a Torch7 ``nn.Sequential``."""
    from bigdl_tpu_torch.nn import layers as L
    from bigdl_tpu_torch.utils.torch_file import (TorchObject, load_t7,
                                                  load_torch_module, save_t7)

    def obj(m):
        if isinstance(m, L.SpatialConvolution):
            return TorchObject("nn.SpatialConvolution", {
                "nInputPlane": m.n_input_plane,
                "nOutputPlane": m.n_output_plane, "kW": m.kernel_w,
                "kH": m.kernel_h, "dW": m.stride_w, "dH": m.stride_h,
                "padW": m.pad_w, "padH": m.pad_h,
                "weight": m.weight, "bias": m.bias})
        if isinstance(m, L.SpatialMaxPooling):
            return TorchObject("nn.SpatialMaxPooling", {
                "kW": m.kw, "kH": m.kh, "dW": m.dw, "dH": m.dh})
        if isinstance(m, L.Linear):
            return TorchObject("nn.Linear", {"weight": m.weight,
                                             "bias": m.bias})
        if isinstance(m, L.Reshape):
            return TorchObject("nn.Reshape", {"size": np.asarray(m.size)})
        if isinstance(m, L.Dropout):
            return TorchObject("nn.Dropout", {"p": m.p})
        return TorchObject("nn." + type(m).__name__, {})

    tree = TorchObject("nn.Sequential",
                       {"modules": [obj(m) for m in model.modules]})
    path = os.path.join(tmp, "vgg16.t7")
    t0 = time.perf_counter()
    save_t7(path, tree)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = load_torch_module(load_t7(path), device=DEV).evaluate()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    x = torch.randn(P26_FWD_BATCH, 3, CAFFE_IMG, CAFFE_IMG,
                    generator=torch.Generator().manual_seed(27)).to(DEV)
    model.evaluate()
    with torch.no_grad():
        gap = _rel_gap(loaded(x), model(x))
    say(f"phase 26 (c) VGG-16 as a Torch7 nn.Sequential: save_t7 "
        f"{os.path.getsize(path)} bytes in {save_s:.2f} s; load_t7 + "
        f"load_torch_module on the card {load_s:.2f} s; forward at batch "
        f"{P26_FWD_BATCH} against the source's, relative {gap:.3e} (limit "
        f"{P26_T7_TOL:g}) [{smi}]")
    if not gap <= P26_T7_TOL:
        raise AssertionError("VGG-16 .t7 forward off the source's")


def _p26_keras_json(model) -> str:
    """The source ``Sequential`` as a Keras-1.2.2 ``Sequential`` config:
    each conv + ReLU a ``Convolution2D(border_mode="same",
    activation="relu")``, each pool a ``MaxPooling2D``, the reshape a
    ``Flatten``, each hidden ``Linear`` + ReLU a ``Dense(activation=
    "relu")``, each ``Dropout`` one, and the head ``Dense`` +
    ``Activation("softmax")``."""
    from bigdl_tpu_torch.nn import layers as L

    mods, layers = list(model.modules), []
    for i, m in enumerate(mods):
        name = f"l{i}"
        relu = i + 1 < len(mods) and isinstance(mods[i + 1], L.ReLU)
        if isinstance(m, L.SpatialConvolution):
            cfg = {"name": name, "nb_filter": m.n_output_plane,
                   "nb_row": m.kernel_h, "nb_col": m.kernel_w,
                   "border_mode": "same", "dim_ordering": "th"}
            if relu:
                cfg["activation"] = "relu"
            if not layers:
                cfg["batch_input_shape"] = [None, m.n_input_plane,
                                            CAFFE_IMG, CAFFE_IMG]
            layers.append({"class_name": "Convolution2D", "config": cfg})
        elif isinstance(m, L.SpatialMaxPooling):
            layers.append({"class_name": "MaxPooling2D", "config": {
                "name": name, "pool_size": [m.kh, m.kw]}})
        elif isinstance(m, L.Reshape):
            layers.append({"class_name": "Flatten", "config": {
                "name": name}})
        elif isinstance(m, L.Linear):
            cfg = {"name": name, "output_dim": m.output_size}
            if relu:
                cfg["activation"] = "relu"
            layers.append({"class_name": "Dense", "config": cfg})
        elif isinstance(m, L.Dropout):
            layers.append({"class_name": "Dropout", "config": {
                "name": name, "p": m.p}})
        elif isinstance(m, L.LogSoftMax):
            layers.append({"class_name": "Activation", "config": {
                "name": name, "activation": "softmax"}})
        elif not isinstance(m, L.ReLU):
            raise AssertionError(f"no Keras layer for {type(m).__name__}")
    return json.dumps({"class_name": "Sequential", "config": layers})


def _p26_keras(model, smi):
    """(d): VGG-16 from a Keras-1.2.2 JSON config."""
    from bigdl_tpu_torch.keras.converter import model_from_json

    t0 = time.perf_counter()
    km = model_from_json(_p26_keras_json(model), device=DEV)
    km.set_weights(model.get_weights())
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x = torch.randn(P26_FWD_BATCH, 3, CAFFE_IMG, CAFFE_IMG,
                    generator=torch.Generator().manual_seed(28)).to(DEV)
    model.evaluate()
    km.core.evaluate()
    with torch.no_grad():
        gap = _rel_gap(km.core(x), torch.exp(model(x)))
    x, y = _p26_images(P26_KERAS_STEPS * P26_BATCH, 29)
    onehot = np.zeros((len(y), 1000), np.float32)
    onehot[np.arange(len(y)), y.astype(int) - 1] = 1.0
    km.compile("sgd", "categorical_crossentropy")
    rec = _P26Losses()
    with _p26_recorded(rec):
        km.fit(x, onehot, batch_size=P26_BATCH, nb_epoch=1)
    loss = [rec.loss[k] for k in sorted(rec.loss)]
    at = [rec.at[k] for k in sorted(rec.at)]
    step_ms = (at[-1] - at[0]) / (len(at) - 1) * 1e3
    say(f"phase 26 (d) VGG-16 from a Keras-1.2.2 JSON config: "
        f"model_from_json + set_weights on the card {build_s:.2f} s; eval "
        f"softmax at batch {P26_FWD_BATCH} against exp of the source's, "
        f"relative {gap:.3e} (limit {P26_KERAS_TOL:g}); compile('sgd', "
        f"'categorical_crossentropy') + fit, {len(loss)} steps of "
        f"{P26_BATCH}: losses {['%.4f' % v for v in loss]}, step "
        f"{step_ms:.3f} ms (mean gap between loss reads after the first) "
        f"[{smi}]")
    if not gap <= P26_KERAS_TOL:
        raise AssertionError("keras VGG-16 off the source")
    if len(loss) != P26_KERAS_STEPS or not all(np.isfinite(loss)):
        raise AssertionError(f"keras fit losses {loss}")


def _p26_finetune(model, path, smi):
    """(b): ``TFTrainingSession`` on the GraphDef beside the source."""
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.nn import ClassNLLCriterion, Identity
    from bigdl_tpu_torch.nn.layers import Dropout
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
    from bigdl_tpu_torch.utils.tf_interop import TFTrainingSession

    x, y = _p26_images((1 + P26_STEPS) * P26_BATCH, 30)
    model.modules = [Identity() if isinstance(m, Dropout) else m
                     for m in model.modules]
    out = {}
    with _deterministic():
        for arm in ("graph", "source"):
            rec = _P26Losses()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ds = ArrayDataSet(x, y, P26_BATCH, shuffle=False)
            end = Trigger.max_iteration(1 + P26_STEPS)
            method = SGD(learningrate=0.01, momentum=0.9)
            t0 = time.perf_counter()
            if arm == "graph":
                sess = TFTrainingSession(path, device=DEV)
                with _p26_recorded(rec):
                    sess.train(ds, ClassNLLCriterion(), method, P26_BATCH,
                               end)
            else:
                opt = LocalOptimizer(model, ds, ClassNLLCriterion(),
                                     P26_BATCH, device=DEV)
                opt.set_optim_method(method).set_end_when(end)
                opt.set_train_summary(rec)
                opt.optimize()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            at = [rec.at[k] for k in sorted(rec.at)]
            out[arm] = ([rec.loss[k] for k in sorted(rec.loss)],
                        (at[-1] - at[0]) / (len(at) - 1) * 1e3,
                        torch.cuda.max_memory_allocated(), wall)
            if arm == "graph":
                del sess
                torch.cuda.empty_cache()
    (gl, gms, gpeak, gwall), (sl, sms, speak, swall) = out["graph"], \
        out["source"]
    gap = max(abs(a - b) / abs(b) for a, b in zip(gl, sl))
    say(f"phase 26 (b) TFTrainingSession(VGG-16 GraphDef).train through "
        f"LocalOptimizer, ClassNLLCriterion, SGD 0.01 momentum 0.9, batch "
        f"{P26_BATCH}, cuDNN deterministic: losses "
        f"{['%.6f' % v for v in gl]}; the source Sequential (Dropout off) "
        f"{['%.6f' % v for v in sl]}; worst relative gap {gap:.3e} (limit "
        f"{P26_LOSS_TOL:g}); step {gms:.3f} ms ({P26_BATCH / gms * 1e3:.1f} "
        f"images/s), peak {gpeak / 2**30:.2f} GiB, {gwall:.1f} s with the "
        f"import, against the source's {sms:.3f} ms "
        f"({P26_BATCH / sms * 1e3:.1f} images/s), peak "
        f"{speak / 2**30:.2f} GiB (steps 2-{1 + P26_STEPS}, mean gap "
        f"between loss reads) [{smi}]")
    if not len(gl) == len(sl) == 1 + P26_STEPS or \
            not all(np.isfinite(gl)) or not gap <= P26_LOSS_TOL:
        raise AssertionError("the fine-tuned GraphDef off the source")


def _p26_flow_graphs():
    """The conditional and the while frame of (e), as GraphDef bytes."""
    from bigdl_tpu_torch.utils.tf_interop import GraphDefBuilder

    rs = np.random.RandomState(31)
    d = P26_FLOW_D
    w = (rs.randn(d, d) / np.sqrt(d)).astype(np.float32)
    c = GraphDefBuilder()
    c.placeholder("x")
    c.placeholder("p")
    c.const("w", w)
    c.op("sw", "Switch", ["x", "p"])
    c.op("neg", "Neg", ["sw"])
    c.op("mm", "MatMul", ["sw:1", "w"])
    c.op("tanh", "Tanh", ["mm"])
    c.op("out", "Merge", ["tanh", "neg"])
    b = GraphDefBuilder()
    b.placeholder("x")
    b.placeholder("cnt")
    b.op("enter_x", "Enter", ["x"])
    b.op("enter_c", "Enter", ["cnt"])
    b.op("merge_x", "Merge", ["enter_x", "next_x"])
    b.op("merge_c", "Merge", ["enter_c", "next_c"])
    b.const("three", np.asarray(3.0, np.float32))
    b.op("less", "Less", ["merge_c", "three"])
    b.op("cond", "LoopCond", ["less"])
    b.op("switch_x", "Switch", ["merge_x", "cond"])
    b.op("switch_c", "Switch", ["merge_c", "cond"])
    b.const("w", w)
    b.const("one", np.asarray(1.0, np.float32))
    b.op("mm", "MatMul", ["switch_x:1", "w"])
    b.op("body_x", "Tanh", ["mm"])
    b.op("body_c", "Add", ["switch_c:1", "one"])
    b.op("next_x", "NextIteration", ["body_x"])
    b.op("next_c", "NextIteration", ["body_c"])
    b.op("exit_x", "Exit", ["switch_x"])
    return {"cond": (c.tobytes(), ["x", "p"], ["out"], [True, False]),
            "while": (b.tobytes(), ["x", "cnt"], ["exit_x"], [0.0, 2.0])}


def _p26_control(smi):
    """(e): control flow on the card against the CPU."""
    from bigdl_tpu_torch import nn as N
    from bigdl_tpu_torch.utils.tf_interop import TensorflowLoader

    x0 = np.random.RandomState(32).randn(P26_FLOW_N, P26_FLOW_D) \
        .astype(np.float32)
    gaps = {}
    loop = None
    for name, (data, ins, outs, seconds) in _p26_flow_graphs().items():
        models = {dev: TensorflowLoader(data=data, device=dev).load(
            ins, outs, loop_max_iterations=P26_LOOP_MAX)
            for dev in (DEV, "cpu")}
        kind = type(models[DEV]).__name__
        for s in seconds:
            res = {}
            for dev, m in models.items():
                xt = torch.from_numpy(x0).to(dev).requires_grad_(True)
                second = torch.tensor(s, device=dev)
                y = m((xt, second))
                torch.sin(y).sum().backward()
                res[dev] = (y.detach(), xt.grad)
            gaps[f"{name} {kind} {s}"] = (_rel_gap(*[res[d][0] for d in
                                                     (DEV, "cpu")]),
                                          _rel_gap(*[res[d][1] for d in
                                                     (DEV, "cpu")]))
        if name == "while":
            loop = models[DEV]
    # the masked loop's cost: P26_LOOP_MAX passes of the body for a loop
    # that stops after 3 (count from 0 to 3), against 3 plain iterations
    xt = torch.from_numpy(x0).to(DEV)
    zero = torch.tensor(0.0, device=DEV)
    lin = [m for m in loop.modules if isinstance(m, N.Linear)][0]

    def plain():
        h = xt
        for _ in range(3):
            h = torch.tanh(lin(h))
        return h

    with torch.no_grad():
        if _rel_gap(loop((xt, zero)), plain()) > P26_FLOW_TOL:
            raise AssertionError("the DynamicGraph's 3 trips off plain")
        loop_ms = time_ms(lambda: loop((xt, zero)))
        plain_ms = time_ms(plain)
    # IfElse and WhileLoop forward; WhileLoop refuses the backward
    ie = N.IfElse(N.Tanh(), N.Negative()).to(DEV)
    xg = torch.from_numpy(x0).to(DEV)
    ie_ok = torch.equal(ie((torch.tensor(True, device=DEV), xg)),
                        torch.tanh(xg)) and torch.equal(
        ie((torch.tensor(False, device=DEV), xg)), -xg)

    class Cond(N.AbstractModule):
        def forward(self, carry):
            return carry[0] < 5

    class Body(N.AbstractModule):
        def forward(self, carry):
            return (carry[0] + 1, torch.tanh(carry[1]))

    wl = N.WhileLoop(Cond(), Body())
    xw = torch.from_numpy(x0).to(DEV).requires_grad_(True)
    i, out = wl((torch.tensor(0, device=DEV), xw))
    want = xw.detach()
    for _ in range(5):
        want = torch.tanh(want)
    wl_ok = int(i) == 5 and _rel_gap(out, want) <= P26_FLOW_TOL
    try:
        out.sum().backward()
        refused = False
    except RuntimeError as e:
        refused = "forward only" in str(e)
    gap_txt = "; ".join(f"{k}: forward {a:.3e}, gradient {b:.3e}"
                        for k, (a, b) in gaps.items())
    say(f"phase 26 (e) control flow at ({P26_FLOW_N}, {P26_FLOW_D}), card "
        f"against the CPU (limit {P26_FLOW_TOL:g}): {gap_txt}; IfElse "
        f"{'right' if ie_ok else 'WRONG'} both ways; WhileLoop forward "
        f"{'right' if wl_ok else 'WRONG'}, backward "
        f"{'refused' if refused else 'NOT refused'}; the DynamicGraph at "
        f"max_iterations {P26_LOOP_MAX} (3 trips) {loop_ms:.4f} ms a "
        f"forward against 3 plain iterations {plain_ms:.4f} ms [{smi}]")
    if not all(a <= P26_FLOW_TOL and b <= P26_FLOW_TOL
               for a, b in gaps.values()):
        raise AssertionError("control flow on the card off the CPU")
    if not (ie_ok and wl_ok and refused):
        raise AssertionError("IfElse or WhileLoop wrong on the card")


def _p26_examples(tmp, smi):
    """(f): the example scripts in child processes."""
    root = os.path.dirname(os.path.abspath(__file__))
    for name, args in P26_EXAMPLES:
        out = os.path.join(tmp, name + ".json")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-c", _EXAMPLE_RUNNER, out, name] + args
            + ["--device", DEV], cwd=root, capture_output=True, text=True,
            timeout=600)
        secs = time.perf_counter() - t0
        if res.returncode != 0:
            raise AssertionError(f"example {name} exited {res.returncode}: "
                                 f"{res.stderr[-3000:]}")
        with open(out) as f:
            rec = json.load(f)
        value = rec["value"]
        acc = value[1] if isinstance(value, list) else value
        losses = rec["losses"]
        say(f"phase 26 (f) python -m bigdl_tpu_torch.examples.{name} "
            f"{' '.join(args)}: {len(losses)} losses, first "
            f"{losses[0]:.4f}, last {losses[-1]:.4f}; accuracy "
            f"{acc:.4f}; {secs:.1f} s in all [{smi}]")
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"example {name}: losses {losses}")


def phase_front_ends(smi: str) -> None:
    """Phase 26: control flow and the model front ends, VGG-16 at full
    width (see the constants above); no kernel of ``csrc/`` runs."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.models.vgg import build_vgg16
    from bigdl_tpu_torch.ops import _cuda

    t_phase = time.perf_counter()
    _cuda.reset_launches()
    tmp = tempfile.mkdtemp(prefix="phase26_")
    try:
        RandomGenerator.RNG.set_seed(0)
        model = build_vgg16(1000, device=DEV)
        path = _p26_tf(model, tmp, smi)
        _p26_t7(model, tmp, smi)
        _p26_keras(model, smi)
        torch.cuda.empty_cache()
        _p26_finetune(model, path, smi)
        del model
        torch.cuda.empty_cache()
        _p26_control(smi)
        _p26_examples(tmp, smi)
        if any(_model_launches().values()):
            raise AssertionError(f"phase 26 launched a kernel of csrc/: "
                                 f"{_model_launches()}")
    finally:
        Engine.reset()
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    say(f"phase 26 took {time.perf_counter() - t_phase:.1f} s")


# ---- phase 27: the fleet observability and control plane ----------------
# (a) the fused ResNet-50 at bench.py's widths (TRAIN_BATCH, TRAIN_IMG,
# TRAIN_CLASSES, bf16, SGD with momentum 0.9, P27_BATCHES batches an
# epoch) through DistriOptimizer at
# world 1 in a child of the restart supervisor: attempt 0 is SIGTERM'd at
# step P27_PREEMPT_AT, attempt 1 checkpoints every P27_CKPT_EVERY steps and
# exits 1 after step P27_CRASH_AT, attempt 2 ends at step P27_STEPS
P27_STEPS, P27_PREEMPT_AT, P27_CKPT_EVERY, P27_CRASH_AT = 14, 5, 8, 10
# batches an epoch (each of TRAIN_BATCH images from seed 0, no shuffle)
P27_BATCHES = 4
# (b) attempt 2 holds at its last step while the endpoints are read (a
# hold before a later step would put its seconds into the autoscaler's
# next step-time sample)
P27_HOLD_AT, P27_LR = P27_STEPS, 0.1
P27_PROF_HZ, P27_PROF_BUDGET, P27_GOODPUT_WINDOW = 100.0, 0.01, 2
# a sample's own work may take the overhead ratio past the budget once
# before the next check skips (at most this much at the first read), and
# the skipping brings it back within this many seconds
P27_PROF_SLACK, P27_PROF_SETTLE_S = 1e-3, 5.0
# the uninterrupted child's profiler A/B: steps from 3 on, in blocks
P27_AB_BLOCK = 4
# (d) the autoscaler's poll, and the gates
P27_AUTOSCALE_INTERVAL, P27_STEP_TIME_TOL, P27_RATIO_TOL = 0.1, 0.2, 0.02
# each step-time sample against the loss reads of the steps it spans: a
# restore's seconds in a sample put it several times past (the stamps and
# the reads are a few statements apart on the child's main thread)
P27_SAMPLE_TOL = 0.5
P27_BACKOFF_TOL, P27_TIMEOUT = 0.05, 600
# (b) the rule that fires once on attempt 2: the window goodput is at
# most 1, so it breaches at every window tick and fires at the second
P27_RULE = {"name": "p27_window_goodput", "type": "threshold",
            "metric": "bigdl_goodput_window_ratio", "op": "<",
            "value": 1.01, "for": 2, "severity": "warning"}
# the spans a training step runs in (the profiler's attribution)
P27_TRAIN_SPANS = ("iteration", "step_dispatch", "device_put", "computing",
                   "batch_prep", "checkpoint", "checkpoint.snapshot",
                   "checkpoint.write",
                   # the step's regions inside step_dispatch, and the
                   # loop's loss read
                   "step.forward", "step.backward", "step.exchange",
                   "step.clip", "step.update", "step.guard", "step.write",
                   "loss_read")
# (e) the four example scripts at their defaults
P27_EXAMPLES = [("train_ptb_lstm", []), ("train_cifar_resnet", []),
                ("finetune_frozen_backbone", []),
                ("dl_classifier_example", [])]

_P27_CHILD = r"""
import json, os, signal, sys, time
import numpy as np, torch
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
import chip_smoke as C
mode, ck, out, tmp, dev = sys.argv[1:6]
C.DEV = dev
C.TRAIN_BATCH, C.TRAIN_IMG, C.TRAIN_CLASSES = map(int, sys.argv[6:9])
attempt = int(os.environ.get("BIGDL_TORCH_ELASTIC_ATTEMPT", "0"))
# only attempt 2 bundles, under the one rule (b) reads
if mode == "supervised" and attempt == 2:
    os.environ["BIGDL_TORCH_BUNDLE_DIR"] = os.path.join(tmp, "bundles")
    os.environ["BIGDL_TORCH_ALERT_RULES"] = json.dumps([C.P27_RULE])
else:
    os.environ.pop("BIGDL_TORCH_BUNDLE_DIR", None)
from bigdl_tpu_torch.common import RandomGenerator
from bigdl_tpu_torch.dataset import ArrayDataSet
from bigdl_tpu_torch.engine import Engine
from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
from bigdl_tpu_torch.obs import prof
from bigdl_tpu_torch.ops import _cuda
from bigdl_tpu_torch.optim import SGD, DistriOptimizer, Trigger
from bigdl_tpu_torch.resilience import elastic
from bigdl_tpu_torch.utils import tree as T
if dev == "cpu":
    # the CPU rehearsal runs the plain versions: count their calls
    from bigdl_tpu_torch.nn import fused
    _real = fused.conv_bn_stats

    def _counted(x, w, *a, **k):
        _cuda.launches["conv_bn_1x1" if w.dim() == 2 else
                       "conv_bn_kxk"] += 1
        return _real(x, w, *a, **k)
    fused.conv_bn_stats = _counted
rec = {"mode": mode, "attempt": attempt, "pid": os.getpid(), "losses": {},
       "at": {}, "calls": 0, "prof": {}}


def _prof(on):
    os.environ["BIGDL_TORCH_PROF_HZ"] = str(C.P27_PROF_HZ if on else 0)
    prof.get_profiler()


class Hook:
    def add_scalar(self, tag, value, step):
        if tag != "Loss":
            return
        rec["losses"][step] = float(value)
        rec["at"][step] = time.perf_counter()
        if mode == "plain":
            # the A/B: blocks of P27_AB_BLOCK steps from step 3, on first
            if step >= 2:
                on = ((step - 2) // C.P27_AB_BLOCK) % 2 == 0
                rec["prof"][step + 1] = on
                _prof(on)
        elif attempt == 0 and step == C.P27_PREEMPT_AT:
            os.kill(os.getpid(), signal.SIGTERM)
            deadline = time.time() + 60
            while not elastic.preemption_requested():
                if time.time() > deadline:
                    raise RuntimeError("the SIGTERM never arrived")
                time.sleep(0.01)
        elif attempt == 1 and step == C.P27_CRASH_AT:
            sys.exit(1)
        elif attempt == 2 and step == C.P27_HOLD_AT:
            with open(os.path.join(tmp, "ready"), "w") as f:
                f.write(str(os.getpid()))
            deadline = time.time() + 300
            while not os.path.exists(os.path.join(tmp, "release")):
                if time.time() > deadline:
                    raise RuntimeError("never released")
                time.sleep(0.02)

    def get_summary_trigger(self, name):
        return None


def main():
    Engine.init(dev)
    model = C._training_resnet50(True)
    n = C.P27_BATCHES * C.TRAIN_BATCH
    x = np.random.RandomState(0).randn(
        n, 3, C.TRAIN_IMG, C.TRAIN_IMG).astype(np.float32)
    y = (np.random.RandomState(1).randint(0, C.TRAIN_CLASSES, n)
         + 1).astype(np.float32)
    RandomGenerator.RNG.set_seed(1)
    # no shuffle: a resumed run sees each batch's rows in the same order
    opt = DistriOptimizer(model, ArrayDataSet(x, y, C.TRAIN_BATCH,
                                              shuffle=False),
                          CrossEntropyCriterion(), C.TRAIN_BATCH,
                          device=dev, wire_dtype="float32")
    opt.set_optim_method(SGD(learningrate=C.P27_LR, momentum=0.9))
    opt.set_compute_dtype("bfloat16")
    # a trigger on the loss reads each step's loss before the next step
    # (no pipelining), so a step's dispatch-to-loss is its period, the
    # interval the autoscaler's stamps measure
    opt.set_end_when(Trigger.or_(Trigger.max_iteration(C.P27_STEPS),
                                 Trigger.min_loss(-1.0)))
    if mode == "supervised":
        opt.set_checkpoint(ck, Trigger.several_iteration(C.P27_CKPT_EVERY))
    opt.set_train_summary(Hook())
    real = opt._train_step

    def counted(*a, **k):
        rec["calls"] += 1
        return real(*a, **k)
    opt._train_step = counted
    if mode == "supervised":
        extra = elastic.restore_latest(opt)
        rec["resumed_at"] = None if extra is None else opt.state["neval"]
    else:
        _prof(False)
    opt.optimize()
    if dev == "cuda":
        torch.cuda.synchronize()
    np.savez(out, *[v.detach().cpu().numpy() for v in
                    T.leaves(model.params()) + T.leaves(model.state())],
             velocity=opt.optim_method.state["velocity"].cpu().numpy())


try:
    main()
finally:
    rec["launches"] = {k: _cuda.launches[k]
                       for k in ("conv_bn_1x1", "conv_bn_kxk")}
    print("P27CHILD " + json.dumps(rec), flush=True)
    Engine.reset()
"""


def _p27_env(extra: dict) -> dict:
    """The children's environment: this process's, without its own
    BIGDL_TORCH_* knobs (the kernels' build place and compiler stay),
    plus ``extra``."""
    keep = ("BIGDL_TORCH_BUILD_DIR", "BIGDL_TORCH_NVCC")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BIGDL_TORCH_") or k in keep}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _p27_records(log: str) -> list:
    return [json.loads(line[len("P27CHILD "):])
            for line in log.splitlines() if line.startswith("P27CHILD ")]


def _p27_child_argv(mode, ck, out, tmp) -> list:
    return [sys.executable, "-c", _P27_CHILD, mode, ck, out, tmp, DEV,
            str(TRAIN_BATCH), str(TRAIN_IMG), str(TRAIN_CLASSES)]


def _p27_launch_check(rec) -> None:
    calls = rec["calls"]
    want = {"conv_bn_1x1": 36 * calls, "conv_bn_kxk": 16 * calls}
    if calls <= 0 or rec["launches"] != want:
        raise AssertionError(f"phase 27: the {rec['mode']} child (attempt "
                             f"{rec['attempt']}) launched {rec['launches']} "
                             f"in {calls} steps, not 36/16 a step")


def _p27_plain_start(tmp):
    """Start the uninterrupted child (it runs beside the supervised
    one); returns (process, its log file, start time)."""
    root = os.path.dirname(os.path.abspath(__file__))
    log = open(os.path.join(tmp, "plain.log"), "w")
    proc = subprocess.Popen(
        _p27_child_argv("plain", os.path.join(tmp, "ck_plain"),
                        os.path.join(tmp, "plain.npz"), tmp),
        cwd=root, env=_p27_env({}), stdout=log, stderr=subprocess.STDOUT)
    return proc, log, time.perf_counter()


def _p27_plain(started, smi) -> dict:
    """The uninterrupted child's end, and its profiler A/B."""
    proc, log, t0 = started
    try:
        rc = proc.wait(timeout=P27_TIMEOUT)
    finally:
        proc.kill()
        log.close()
    with open(log.name) as f:
        out = f.read()
    if rc != 0:
        raise AssertionError(f"phase 27 uninterrupted child exited {rc}: "
                             f"{out[-4000:]}")
    (rec,) = _p27_records(out)
    _p27_launch_check(rec)
    at = {int(k): v for k, v in rec["at"].items()}
    on = {int(k): v for k, v in rec["prof"].items()}
    gaps = {n: (at[n] - at[n - 1]) * 1e3 for n in at if n - 1 in at
            and n in on}
    ms_on = [g for n, g in gaps.items() if on[n]]
    ms_off = [g for n, g in gaps.items() if not on[n]]
    rec["ms_on"] = float(np.mean(ms_on)) if ms_on else float("nan")
    rec["ms_off"] = float(np.mean(ms_off)) if ms_off else float("nan")
    say(f"phase 27 (a) uninterrupted child (beside the supervised run): "
        f"{len(at)} steps in {time.perf_counter() - t0:.1f} s, "
        f"{rec['launches']} launches in "
        f"{rec['calls']} steps; fused step {rec['ms_on']:.2f} ms with the "
        f"profiler at {P27_PROF_HZ:g} Hz ({len(ms_on)} steps) and "
        f"{rec['ms_off']:.2f} ms off ({len(ms_off)} steps), alternate "
        f"{P27_AB_BLOCK}-step blocks, no gate [{smi}]")
    return rec


def _p27_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=30) as r:
        return r.status, json.loads(r.read())


def _p27_hold(tmp, smi) -> dict:
    """(b), while attempt 2 holds at step P27_HOLD_AT."""
    from bigdl_tpu_torch.obs import bundle, prof

    with open(os.path.join(tmp, "port")) as f:
        port = int(f.read().strip())
    import urllib.request

    from bigdl_tpu_torch.obs.aggregate import FleetAggregator
    from bigdl_tpu_torch.obs.retain import RetentionStore

    _, hz = _p27_get(port, "/healthz")
    _, pz = _p27_get(port, "/profilez")
    # the cap: a ratio read past the budget (one sample's work over the
    # check that allowed it) comes back under it, with samples skipped
    first_oh, settle = hz["prof_overhead"], 0.0
    t_read = time.perf_counter()
    while hz["prof_overhead"] is not None and \
            hz["prof_overhead"] > P27_PROF_BUDGET + P27_PROF_SLACK and \
            time.perf_counter() - t_read < P27_PROF_SETTLE_S:
        time.sleep(0.1)
        _, hz = _p27_get(port, "/healthz")
        settle = time.perf_counter() - t_read
    if settle:
        _, pz2 = _p27_get(port, "/profilez")
        if pz2["skipped"] <= pz["skipped"]:
            raise AssertionError(f"phase 27 (b) the profiler read "
                                 f"{first_oh} and skipped no sample")
        pz = pz2
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=30) as r:
        metrics_text = r.read().decode("utf-8")
    # (d) the fleet scrape of the live child into the retention store
    agg = FleetAggregator(peers=[f"127.0.0.1:{port}"])
    store = RetentionStore(directory=os.path.join(tmp, "retain"))
    for _ in range(2):
        fleet = agg.snapshot()
        store.ingest_snapshot(time.time(), fleet)
    kept = RetentionStore(directory=os.path.join(tmp, "retain"))
    replayed = kept.load()
    if not store.summary() or not replayed or \
            fleet["hosts"].get("0", {}).get("step") != P27_HOLD_AT:
        raise AssertionError(f"phase 27 (d) fleet scrape {fleet}, "
                             f"retention {store.summary()}")
    bdir = os.path.join(tmp, "bundles")
    inv = bundle.inventory(bdir)
    code, dz = _p27_get(port, "/debugz")
    _, hz2 = _p27_get(port, "/healthz")
    inv2 = bundle.inventory(bdir)
    ratio = hz["goodput_ratio"]
    if hz["attempt"] != 2 or ratio is None or not 0 < ratio <= 1:
        raise AssertionError(f"phase 27 (b) /healthz: {hz}")
    if hz["prof_overhead"] is None or \
            hz["prof_overhead"] > P27_PROF_BUDGET + P27_PROF_SLACK:
        raise AssertionError(f"phase 27 (b) profiler overhead "
                             f"{hz['prof_overhead']} past the budget "
                             f"{P27_PROF_BUDGET}")
    if [a["rule"] for a in hz["alerts"]] != [P27_RULE["name"]] or \
            hz["bundles"] < 1:
        raise AssertionError(f"phase 27 (b) alerts {hz['alerts']}, "
                             f"bundles {hz['bundles']}")
    if len(inv) != 1 or not inv[0]["ok"] or inv[0]["trigger"] != "alert":
        raise AssertionError(f"phase 27 (b) the alert's bundles: {inv}")
    ok, why = bundle.verify_bundle(inv[0]["path"])
    with open(os.path.join(inv[0]["path"], "runtime.json")) as f:
        runtime = json.load(f)
    mem = runtime.get("device_memory") or {}
    if not ok or DEV == "cuda" and not mem.get("peak_bytes_in_use"):
        raise AssertionError(f"phase 27 (b) bundle {inv[0]['name']}: "
                             f"{why}, runtime {runtime}")
    spanned = [line for line in pz["collapsed"]
               if not line.startswith(prof.NO_SPAN + ";")]
    top = spanned[0].split(";", 1)[0] if spanned else None
    if not pz["enabled"] or top not in P27_TRAIN_SPANS:
        raise AssertionError(f"phase 27 (b) /profilez: the heaviest "
                             f"span-attributed stack is under {top!r}")
    if code != 200 or not dz.get("bundle") or len(inv2) != 2 or \
            not all(b["ok"] for b in inv2) or hz2["bundles"] != 2:
        raise AssertionError(f"phase 27 (b) /debugz: {code} {dz}")
    say(f"phase 27 (b) attempt 2 at step {hz['step']}: /healthz attempt "
        f"{hz['attempt']}, goodput {ratio:.4f}, profiler overhead "
        f"{hz['prof_overhead']:.5f} (budget {P27_PROF_BUDGET}; first read "
        f"{first_oh:.5f}, {settle:.1f} s to come back) over "
        f"{pz['samples']} samples ({pz['skipped']} skipped), heaviest "
        f"span-attributed stack under {top!r}; rule {P27_RULE['name']} "
        f"fired once: 1 alert bundle ({why}; runtime.json peak "
        f"{mem.get('peak_bytes_in_use')} B), /debugz wrote a second; "
        f"the fleet scrape of the child into the retention store: "
        f"{len(store.summary())} series, {replayed} points replayed from "
        f"its JSONL [{smi}]")
    return {"health": hz, "metrics_text": metrics_text}


def _p27_supervised(tmp, smi) -> dict:
    """(a)-(b): the supervisor's run; returns the children's records,
    the supervisor's output and the hold's reads."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = _p27_env({
        "BIGDL_TORCH_TRACE_DIR": os.path.join(tmp, "trace"),
        "BIGDL_TORCH_METRICS_DIR": os.path.join(tmp, "metrics"),
        "BIGDL_TORCH_OBS_PORT": "0",
        "BIGDL_TORCH_OBS_PORT_FILE": os.path.join(tmp, "port"),
        "BIGDL_TORCH_GOODPUT_WINDOW": P27_GOODPUT_WINDOW,
        "BIGDL_TORCH_PROF_HZ": P27_PROF_HZ,
        "BIGDL_TORCH_PROF_BUDGET": P27_PROF_BUDGET,
        "BIGDL_TORCH_BUNDLE_DIR": os.path.join(tmp, "sup_bundles"),
        "BIGDL_TORCH_AUTOSCALE_DRY_RUN": 1,
        "BIGDL_TORCH_AUTOSCALE_MIN_WORLD": 1,
        "BIGDL_TORCH_AUTOSCALE_MAX_WORLD": 1,
        "BIGDL_TORCH_AUTOSCALE_INTERVAL": P27_AUTOSCALE_INTERVAL,
        "BIGDL_TORCH_AUTOSCALE_WARMUP": 0,
        "BIGDL_TORCH_AUTOSCALE_HYSTERESIS": 1,
        # always breached: every evaluation is logged with its signals
        "BIGDL_TORCH_AUTOSCALE_STEP_TIME_HIGH": 1e-6,
        "BIGDL_TORCH_AUTOSCALE_GOODPUT_FLOOR": 1.01})
    cmd = [sys.executable, "-m", "bigdl_tpu_torch.resilience.supervisor",
           "--autoscale", "--max-retries", "3", "--"] + _p27_child_argv(
        "supervised", os.path.join(tmp, "ck"),
        os.path.join(tmp, "supervised.npz"), tmp)
    log_path = os.path.join(tmp, "supervisor.log")
    t0 = time.perf_counter()
    hold = None
    with open(log_path, "w") as logf:
        sup = subprocess.Popen(cmd, cwd=root, env=env, stdout=logf,
                               stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.time() + P27_TIMEOUT
            while not os.path.exists(os.path.join(tmp, "ready")):
                if sup.poll() is not None or time.time() > deadline:
                    break
                time.sleep(0.05)
            else:
                try:
                    hold = _p27_hold(tmp, smi)
                finally:
                    with open(os.path.join(tmp, "release"), "w") as f:
                        f.write("go")
            rc = sup.wait(timeout=P27_TIMEOUT)
        finally:
            sup.kill()
    with open(log_path) as f:
        log = f.read()
    if rc != 0 or hold is None:
        raise AssertionError(f"phase 27 (a) the supervisor exited {rc} "
                             f"(held: {hold is not None}): {log[-5000:]}")
    recs = _p27_records(log)
    if [r["attempt"] for r in recs] != [0, 1, 2]:
        raise AssertionError(f"phase 27 (a) attempts "
                             f"{[r['attempt'] for r in recs]}: {log[-4000:]}")
    for r in recs:
        _p27_launch_check(r)
    return {"recs": recs, "log": log, "hold": hold,
            "seconds": time.perf_counter() - t0}


def _p27_after(tmp, run, plain, smi) -> dict:
    """(a)'s gates on the finished run, (c) and (d)."""
    from bigdl_tpu_torch.obs import aggregate, goodput, report
    from bigdl_tpu_torch.obs import names as N

    recs = run["recs"]
    mdir, tdir = os.path.join(tmp, "metrics"), os.path.join(tmp, "trace")
    # (a) bit-equal to the uninterrupted child
    a = np.load(os.path.join(tmp, "supervised.npz"))
    b = np.load(os.path.join(tmp, "plain.npz"))
    if sorted(a.files) != sorted(b.files) or not all(
            np.array_equal(a[k], b[k]) for k in a.files):
        diff = max(float(np.abs(a[k] - b[k]).max()) for k in a.files)
        raise AssertionError(f"phase 27 (a) the supervised run ended "
                             f"{diff:.3e} from the uninterrupted one")
    losses = {}
    for r in recs:
        losses.update({int(k): v for k, v in r["losses"].items()})
    plain_l = {int(k): v for k, v in plain["losses"].items()}
    if any(losses[n] != plain_l[n] for n in losses):
        raise AssertionError("phase 27 (a) a loss differs from the "
                             "uninterrupted child's")
    resumed = [r.get("resumed_at") for r in recs]
    snaps = report.load_metric_snapshots(mdir)
    restarts = {}
    for snap in snaps:
        fam = (snap.get("metrics") or {}).get(N.SUPERVISOR_RESTARTS_TOTAL)
        for s in (fam or {}).get("samples", []):
            restarts[s["labels"]["kind"]] = int(s["value"])
    # attempt 1 resumes right after attempt 0's last step (the emergency
    # checkpoint), attempt 2 at the periodic checkpoint's
    last0 = max(int(k) for k in recs[0]["losses"])
    if restarts != {"preempted": 1, "transient": 1} or \
            resumed != [None, last0 + 1, P27_CKPT_EVERY + 1]:
        raise AssertionError(f"phase 27 (a) restarts {restarts}, resumed "
                             f"at {resumed}")
    calls = sum(r["calls"] for r in recs)
    launches = {k: sum(r["launches"][k] for r in recs)
                for k in ("conv_bn_1x1", "conv_bn_kxk")}
    say(f"phase 27 (a) supervisor exit 0 after 3 attempts (resumed at "
        f"{resumed[1:]}), restarts {restarts}; weights, BN state and "
        f"momentum bit-equal to the uninterrupted child, every loss "
        f"equal; {launches} launches in {calls} dispatched steps (36/16 a "
        f"step in each child); {run['seconds']:.1f} s [{smi}]")
    # (c) the goodput ledger across the attempts
    gp = goodput.aggregate_goodput(mdir)
    shards = goodput.read_ledger_shards(mdir)
    rework = sorted(rec["step"] for sh in shards for rec in sh["records"]
                    if rec.get("kind") == "rework")
    want = list(range(P27_CKPT_EVERY + 1, P27_CRASH_AT + 1))
    if gp is None or gp["rework_steps"] != len(want) or rework != want \
            or not 0 < gp["goodput_ratio"] <= 1:
        raise AssertionError(f"phase 27 (c) goodput {gp}, rework steps "
                             f"{rework}")
    backoff = [rec for sh in shards for rec in sh["records"]
               if rec.get("kind") == "supervisor_backoff"]
    shards_t = aggregate.read_shards(tdir)
    events = [(sh, rec) for sh in shards_t for rec in sh.records]
    delays = [rec["attrs"]["delay_s"] for _, rec in events
              if rec.get("name") == "supervisor.backoff"]
    if len(backoff) != 1 or len(delays) != 1 or \
            abs(backoff[0]["dur_s"] - delays[0]) > P27_BACKOFF_TOL:
        raise AssertionError(f"phase 27 (c) supervisor_backoff {backoff} "
                             f"against the policy's delays {delays}")
    saves = [(rec.get("attempt"), rec["dur_s"]) for sh in shards
             for rec in sh["records"] if rec.get("kind") == "checkpoint_save"]
    loads = [(rec.get("attempt"), rec["dur_s"]) for sh in shards
             for rec in sh["records"]
             if rec.get("kind") == "checkpoint_restore"]
    say(f"phase 27 (c) goodput over {gp['attempts']} shards (3 children, "
        f"the supervisor): ratio {gp['goodput_ratio']:.4f}, "
        f"{gp['steps']} productive steps, rework steps {rework}, "
        f"total {gp['total_s']:.2f} s, unknown {gp['unknown_s']:.2f} s, "
        f"badput {gp['badput_s']}; supervisor_backoff "
        f"{backoff[0]['dur_s']:.4f} s against the policy's "
        f"{delays[0]:.4f} s; checkpoint saves (attempt, s) {saves}, "
        f"restores {loads} [{smi}]")
    # (c) the report CLI and the trace merge
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = report.main([tdir, "--metrics-dir", mdir])
    text = out.getvalue()
    for head in ("-- goodput --", "-- alerts --", "-- resilience events --"):
        if code != 0 or head not in text:
            raise AssertionError(f"phase 27 (c) the report lacks {head}: "
                                 f"{text[-3000:]}")
    if P27_RULE["name"] not in text or "rework" not in text:
        raise AssertionError(f"phase 27 (c) report: {text[-3000:]}")
    merged = aggregate.merge_trace_dir(tdir, os.path.join(tmp,
                                                          "merged.json"))
    aligned = merged["shards"] - len(merged["unaligned"])
    if aligned != 3 or merged["shards"] != 4:
        raise AssertionError(f"phase 27 (c) trace merge: {merged}")
    say(f"phase 27 (c) report CLI (its main, in this process): "
        f"{len(text.splitlines())} lines with "
        f"the goodput, alerts and resilience sections; trace merge: "
        f"{merged['shards']} shards, {aligned} barrier-aligned (the "
        f"children; the supervisor's has no barrier), offsets "
        f"{merged['offsets_s']}, {merged['events']} events")
    # (d) the autoscaler's evaluations in dry run
    evals = [rec for _, rec in events if rec.get("name") ==
             "elastic.autoscale"]
    steps_t, due, spans = _p27_due_step_times(evals, events, recs)
    p50s = []
    for snap in snaps:
        fam = (snap.get("metrics") or {}).get(N.STEP_TIME_SECONDS)
        for s in (fam or {}).get("samples", []):
            if s["labels"].get("quantile") == "p50":
                p50s.append(s["value"])
    # the children's per-step period, the gaps between their loss reads
    # (the hold's gap left out): printed beside the gate, which holds the
    # samples to the loss reads of the steps each spans
    gaps = []
    for r in recs:
        at = {int(k): v for k, v in r["at"].items()}
        gaps += [at[n] - at[n - 1] for n in at if n - 1 in at
                 and not (r["attempt"] == 2 and n - 1 == P27_HOLD_AT)]
    executed = [e for e in evals if not e["attrs"].get("suppressed")
                and not e["attrs"].get("dry_run")]
    if not steps_t or len(p50s) != 3 or not gaps or executed or any(
            e["attrs"].get("suppressed") != "at_bound" for e in evals):
        raise AssertionError(f"phase 27 (d) autoscale events {evals[:4]}, "
                             f"p50s {p50s}")
    st, p50 = float(np.median(steps_t)), float(np.median(p50s))
    want, period = float(np.median(due)), float(np.median(gaps))
    worst = max(abs(s - d) / d for s, d in zip(steps_t, due))
    hz = run["hold"]["health"]
    near = min((e for e in evals if "goodput_ratio" in
                (e["attrs"].get("signals") or {})),
               key=lambda e: abs(e["wall_time"] - hz["time"]))
    gap = abs(near["attrs"]["signals"]["goodput_ratio"] - hz["goodput_ratio"])
    if abs(st - want) > P27_STEP_TIME_TOL * want or \
            worst > P27_SAMPLE_TOL or gap > P27_RATIO_TOL:
        raise AssertionError(f"phase 27 (d) step_time_s {st:.4f} against "
                             f"the children's step period {want:.4f} over "
                             f"the same steps (samples {steps_t}, due "
                             f"{due}, steps a sample {spans}; per-step "
                             f"median {period:.4f}, runtime p50 "
                             f"{p50:.4f}); goodput "
                             f"{near['attrs']['signals']} against /healthz "
                             f"{hz['goodput_ratio']}")
    return {"evals": len(evals), "step_time_s": st, "p50": p50,
            "due": want, "period": period, "samples": len(steps_t),
            "spans": spans, "worst": worst,
            "ratio_gap": gap, "launches": launches}


def _p27_due_step_times(evals, events, recs):
    """What each of the autoscaler's step-time samples should read: a
    sample is the step-stamp delta between two scrapes of one child over
    the steps between them, so its due value is that child's own
    loss-read period over those same steps.  (A median of per-step gaps
    is another statistic: a scrape that spans a slow step and a fast one
    averages them.)  Returns the due values in the samples' order and
    the samples, their due values and the steps each spans, in the
    order of the evaluations."""
    import bisect

    # the supervisor's restarts split its evaluations by child; like
    # the autoscaler (on_launch), a new child starts with no memory
    bounds = sorted(rec["wall_time"] for _, rec in events
                    if rec.get("name") == "elastic.restart")
    ats = [{int(k): v for k, v in r["at"].items()} for r in recs]
    got, due, spans, last = [], [], [], {}
    for e in sorted(evals, key=lambda e: e["wall_time"]):
        sig = e["attrs"].get("signals") or {}
        if "step" not in sig:
            continue
        child = bisect.bisect(bounds, e["wall_time"])
        step, prev = int(sig["step"]), last.get(child)
        last[child] = step
        if "step_time_s" not in sig:
            continue
        at = ats[child] if child < len(ats) else {}
        if prev is None or step <= prev or prev not in at or step not in at:
            raise AssertionError(
                f"phase 27 (d) a step-time sample at step {step} of child "
                f"{child} follows step {prev}: not a span of its loss reads "
                f"{sorted(at)}")
        got.append(sig["step_time_s"])
        due.append((at[step] - at[prev]) / (step - prev))
        spans.append(step - prev)
    return got, due, spans


def _p27_rollup(child_text: str, smi) -> None:
    """(d): a two-tier rollup over the held child's ``/metrics`` and this
    process's exposition, against the flat merge of the same two."""
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.obs import metrics as M
    from bigdl_tpu_torch.obs import names as N
    from bigdl_tpu_torch.obs import rollup

    bodies = {"child:9100": child_text,
              "parent:9100": obs.get_registry().to_prometheus()}
    addrs = sorted(bodies)

    def fetch(url):
        host, _, path = url.split("//", 1)[1].partition("/")
        if path.startswith("healthz"):
            return json.dumps({"time": time.time(), "host": host})
        return bodies[host]

    root, leaves = rollup.build_tiers(addrs, fetch, shard_size=1)
    tiered = root.refresh()
    flat = rollup.merge_parsed([M.parse_prometheus(bodies[a])
                                for a in addrs])
    fam = N.PHASE_SECONDS
    qs = [(q, rollup.fleet_quantile(tiered, fam, q),
           rollup.fleet_quantile(flat, fam, q)) for q in (0.5, 0.9, 0.99)]
    if not all(t is not None and t == f for _, t, f in qs):
        raise AssertionError(f"phase 27 (d) rollup quantiles {qs}")
    say(f"phase 27 (d) two-tier rollup ({len(leaves)} leaves) over the "
        f"child's /metrics and this process's exposition: {fam} "
        f"p50/p90/p99 {[t for _, t, _ in qs]} bit-identical to the flat "
        f"merge [{smi}]")


def _p27_examples(tmp, smi) -> None:
    """(e): the four example scripts at their defaults, at once, each in
    a child process timed to its own exit."""
    root = os.path.dirname(os.path.abspath(__file__))
    running = {}
    for name, args in P27_EXAMPLES:
        out = os.path.join(tmp, name + ".json")
        log = open(os.path.join(tmp, name + ".log"), "w")
        running[name] = (subprocess.Popen(
            [sys.executable, "-c", _EXAMPLE_RUNNER, out, name] + args
            + ["--device", DEV], cwd=root, env=_p27_env({}), stdout=log,
            stderr=subprocess.STDOUT), out, log, time.perf_counter())
    done, deadline = {}, time.time() + P27_TIMEOUT
    try:
        while len(done) < len(running):
            for name, (proc, _, log, t0) in running.items():
                if name not in done and proc.poll() is not None:
                    done[name] = time.perf_counter() - t0
                    log.close()
            if time.time() > deadline:
                raise AssertionError(f"phase 27 (e) examples still running "
                                     f"after {P27_TIMEOUT} s: "
                                     f"{sorted(set(running) - set(done))}")
            time.sleep(0.05)
    finally:
        for proc, _, log, _ in running.values():
            proc.kill()
            log.close()
    for name, (proc, out, _, _) in running.items():
        if proc.returncode != 0:
            with open(os.path.join(tmp, name + ".log")) as f:
                raise AssertionError(f"phase 27 (e) {name} exited "
                                     f"{proc.returncode}: {f.read()[-3000:]}")
        with open(out) as f:
            rec = json.load(f)
        value, losses = rec["value"], rec["losses"]
        if not losses or not all(np.isfinite(losses)):
            raise AssertionError(f"phase 27 (e) {name}: losses {losses}")
        if name == "finetune_frozen_backbone" and not value > 0.9:
            raise AssertionError(f"phase 27 (e) {name}: accuracy {value}")
        what = "perplexity" if name == "train_ptb_lstm" else "accuracy"
        frozen = ", backbone bit-identical" if "backbone" in name else ""
        say(f"phase 27 (e) {name} at its defaults: {len(losses)} steps, "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, {what} "
            f"{value:.4f}{frozen}; {done[name]:.1f} s (the four at once) "
            f"[{smi}]")


def phase_fleet(smi: str) -> dict:
    """Phase 27: the fleet observability and control plane around a
    supervised, preempted and crashed fused ResNet-50 (see the constants
    above).  Returns the conv_bn launches of the supervised children
    (each child counts from 0: a fresh process)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase27_")
    try:
        started = _p27_plain_start(tmp)
        try:
            run = _p27_supervised(tmp, smi)
        finally:
            plain = _p27_plain(started, smi)
        after = _p27_after(tmp, run, plain, smi)
        say(f"phase 27 (d) autoscaler (dry run, world 1..1): "
            f"{after['evals']} evaluations, all suppressed at the bound, "
            f"none executed; median step_time_s {after['step_time_s']:.4f} "
            f"s over {after['samples']} evaluations (steps a sample "
            f"{after['spans']}) against the children's step period "
            f"{after['due']:.4f} s over the same steps (their loss reads; "
            f"worst sample {after['worst']:.4f} off; per step "
            f"{after['period']:.4f} s; their runtime p50, dispatch to loss, "
            f"{after['p50']:.4f} s); "
            f"goodput_ratio {after['ratio_gap']:.4f} from /healthz's "
            f"[{smi}]")
        _p27_rollup(run["hold"]["metrics_text"], smi)
        _p27_examples(tmp, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"phase 27 took {time.perf_counter() - t_phase:.1f} s")
    return after["launches"]


# phase 28: (b)'s images (128 x 3 x 224 x 224 f32: 77 MB), steps a run
# (two epochs of 4 batches), and (c)'s simulator: hosts, seed, the real
# seconds a partitioned fetch stalls, and its time limit
P28_IMAGES, P28_STEPS = 128, 8
P28_SIM_HOSTS, P28_SIM_SEED, P28_SIM_STALL = 200, 0, 0.01
P28_SIM_JOBS, P28_SIM_TIMEOUT = 7, 600
P28_OBS_ENV = {"BIGDL_TORCH_OBS_PORT": "0", "BIGDL_TORCH_PROF_HZ": "50"}


@contextlib.contextmanager
def _env(values: dict):
    """``values`` in the environment for the block (None: unset), the
    previous values back after it."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _p28_get(srv, path):
    import urllib.request

    with urllib.request.urlopen(srv.url(path), timeout=30) as r:
        return r.status, r.read().decode()


def _p28_sim_start(tmp):
    out = os.path.join(tmp, "sim.json")
    log = open(os.path.join(tmp, "sim.log"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "bigdl_tpu_torch.sim", "--hosts",
         str(P28_SIM_HOSTS), "--seed", str(P28_SIM_SEED),
         "--partition-stall-s", str(P28_SIM_STALL), "--jobs",
         str(P28_SIM_JOBS), "--out", out],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        env=_p27_env({}), stdout=log, stderr=subprocess.STDOUT)
    return proc, out, log, time.perf_counter()


def _p28_served(smi, p4_launches) -> None:
    """(a): the obs plane up at Engine.init, the flagship served under it."""
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.obs import prof, server
    from bigdl_tpu_torch.ops import _cuda

    Engine.reset()
    server.stop_server()
    prof.reset_profiler()
    with _env(dict(P28_OBS_ENV, BIGDL_TORCH_CHECK_SINGLETON=None)):
        try:
            Engine.init(DEV)
            srv = server.get_server()
            if srv is None:
                raise AssertionError("phase 28 (a): Engine.init left no obs "
                                     "server")
            hz_code, hz = _p28_get(srv, "/healthz")
            m_code, metrics = _p28_get(srv, "/metrics")
            status = json.loads(hz)["status"]
            if hz_code != 200 or m_code != 200 or \
                    "bigdl_engine_inits_total" not in metrics:
                raise AssertionError(f"phase 28 (a): /healthz {hz_code}, "
                                     f"/metrics {m_code}")
            if not isinstance(prof.current(), prof.SamplingProfiler):
                raise AssertionError("phase 28 (a): Engine.init started no "
                                     "sampling profiler")
            say(f"phase 28 (a) Engine.init on {DEV}: /healthz 200 "
                f"(status {status}) and /metrics 200 on port {srv.port} "
                f"before any model; {type(prof.current()).__name__} at "
                f"{P28_OBS_ENV['BIGDL_TORCH_PROF_HZ']} Hz")
            prof.reset_profiler()
            model = _flagship(0)
            eng = _lm_engine(model)
            live = prof.current()
            if not isinstance(live, prof.SamplingProfiler):
                raise AssertionError("phase 28 (a): LMEngine started no "
                                     "sampling profiler")
            torch.cuda.synchronize()
            _cuda.reset_launches()
            t0 = time.perf_counter()
            reqs = [eng.submit(p, SERVE_NEW_TOKENS)
                    for p in _serving_prompts()]
            eng.run_until_idle(600)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_cuda.launches)
            st = eng.stats()
            eng.close()
            samples = live.snapshot()["samples"]
            del model, eng
            toks = [r.tokens for r in reqs]
            if any(r.error for r in reqs) or toks != _P4_TOKENS:
                raise AssertionError("phase 28 (a): the tokens served under "
                                     "the obs plane differ from phase 4's")
            for k in ("flash_fwd", "paged_decode"):
                if not 0 < launches[k] == p4_launches[k]:
                    raise AssertionError(f"phase 28 (a): {k} launched "
                                         f"{launches[k]}, phase 4 "
                                         f"{p4_launches[k]}")
            say(f"phase 28 (a) the flagship LMEngine under the obs plane: "
                f"{st['requests']} requests, {st['tokens']} tokens in "
                f"{wall:.3f} s (tokens/s {st['tokens_per_s']:.1f}, ttft p50 "
                f"{st['ttft_p50_s'] * 1e3:.2f} ms), tokens equal to phase "
                f"4's; flash_fwd {launches['flash_fwd']}, paged_decode "
                f"{launches['paged_decode']} launches as in phase 4; the "
                f"profiler took {samples} samples [{smi}]")
            with _env({"BIGDL_TORCH_CHECK_SINGLETON": "1"}):
                try:
                    Engine.init(DEV)
                except RuntimeError as e:
                    say(f"phase 28 (a) a second init under "
                        f"BIGDL_TORCH_CHECK_SINGLETON=1 raises: {e}")
                else:
                    raise AssertionError("phase 28 (a): a second init under "
                                         "BIGDL_TORCH_CHECK_SINGLETON passed")
        finally:
            server.stop_server()
            prof.reset_profiler()
            Engine.reset()
            torch.cuda.empty_cache()


def _p28_arm(x, y, env: dict) -> dict:
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    class Feed(ArrayDataSet):
        """The batches, each kept and its gather (the dataset's next)
        timed."""

        batches, gather_s = [], []

        def data(self, train=True):
            it = super().data(train)
            while True:
                t0 = time.perf_counter()
                try:
                    inp, tgt = next(it)
                except StopIteration:
                    return
                self.gather_s.append(time.perf_counter() - t0)
                self.batches.append((inp, tgt))
                yield inp, tgt

    with _env(env):
        model = _training_resnet50(True)
        RandomGenerator.RNG.set_seed(1)
        feed = Feed(x, y, TRAIN_BATCH)
        losses = _TimedLosses()
        opt = LocalOptimizer(model, feed, CrossEntropyCriterion(),
                             batch_size=TRAIN_BATCH, device=DEV)
        opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
        opt.set_compute_dtype("bfloat16")
        opt.set_train_summary(losses)
        # a trigger on the loss reads each step's loss before the next
        opt.set_end_when(Trigger.or_(Trigger.max_iteration(P28_STEPS),
                                     Trigger.min_loss(-1.0)))
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        opt.optimize()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: _cuda.launches[k]
                    for k in ("conv_bn_1x1", "conv_bn_kxk")}
    del opt, model
    torch.cuda.empty_cache()
    at = losses.at
    gaps = [(at[n + 1] - at[n]) * 1e3 for n in range(2, P28_STEPS)]
    loss = [losses.loss[n] for n in sorted(losses.loss)]
    if len(loss) != P28_STEPS or not all(np.isfinite(loss)):
        raise AssertionError(f"phase 28 (b): losses {loss}")
    want = {"conv_bn_1x1": 36 * P28_STEPS, "conv_bn_kxk": 16 * P28_STEPS}
    if launches != want:
        raise AssertionError(f"phase 28 (b): conv_bn launches {launches}, "
                             f"want {want}")
    return {"loss": loss, "batches": feed.batches, "launches": launches,
            "gather_ms": float(np.median(feed.gather_s)) * 1e3,
            "step_ms": float(np.median(gaps)), "wall_s": wall}


def _p28_trace_counts(trace_dir: str) -> dict:
    """Kernel and annotation counts of the step profiler's one trace."""
    import glob

    files = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"phase 28 (b): trace files {files}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    counts = {"conv_bn_1x1": 0, "conv_bn_kxk": 0}
    for e in events:
        name = e.get("name", "")
        if e.get("cat") == "kernel" and PORT_KERNEL.match(name):
            for k in counts:
                if f"{k}_" in name:
                    counts[k] += 1
        elif e.get("cat") == "user_annotation" and name in (
                "iteration", "device_put", "step_dispatch"):
            counts[name] = counts.get(name, 0) + 1
    counts["bytes"] = os.path.getsize(files[0])
    return counts


def _p28_gather_alone(x, reps: int = 16) -> dict:
    """The row gather of one batch alone, library and numpy, on the
    same index draws."""
    from bigdl_tpu_torch import native

    rs = np.random.RandomState(5)
    sels = [rs.permutation(len(x))[:TRAIN_BATCH] for _ in range(reps)]
    out = {}
    for way, env in (("library", {"BIGDL_TORCH_NO_NATIVE": None}),
                     ("numpy", {"BIGDL_TORCH_NO_NATIVE": "1"})):
        with _env(env):
            ts = []
            for sel in sels:
                t0 = time.perf_counter()
                native.gather_rows(x, sel)
                ts.append(time.perf_counter() - t0)
        out[way] = float(np.median(ts)) * 1e3
    return out


def _p28_native_feed(tmp, smi) -> dict:
    """(b): the fused ResNet-50 fed by the host library, by numpy, and
    by the library under the step profiler.  Returns the library arm's
    conv_bn launches."""
    from bigdl_tpu_torch import native

    if not native.available():
        raise AssertionError(f"phase 28 (b): the host library is not "
                             f"available: {native.unavailable_reason()}")
    say(f"phase 28 (b) host library {native.lib_path(native._compiler())} "
        f"loaded")
    n = P28_IMAGES
    x = np.random.RandomState(0).randn(n, 3, TRAIN_IMG,
                                       TRAIN_IMG).astype(np.float32)
    y = (np.random.RandomState(1).randint(0, TRAIN_CLASSES, n)
         + 1).astype(np.float32)
    trace_dir = os.path.join(tmp, "trace")
    det = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
        True, False
    try:
        alone = _p28_gather_alone(x)
        off = {"BIGDL_TORCH_NO_NATIVE": None, "BIGDL_TORCH_PROFILE": None}
        lib = _p28_arm(x, y, off)
        plain = _p28_arm(x, y, dict(off, BIGDL_TORCH_NO_NATIVE="1"))
        traced = _p28_arm(x, y, dict(off, BIGDL_TORCH_PROFILE=trace_dir))
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            det
    for other, what in ((plain, "numpy"), (traced, "traced")):
        if other["loss"] != lib["loss"]:
            raise AssertionError(f"phase 28 (b): {what} losses "
                                 f"{other['loss']} != {lib['loss']}")
        if len(other["batches"]) != len(lib["batches"]) or not all(
                np.array_equal(a, b) and np.array_equal(ta, tb)
                for (a, ta), (b, tb) in zip(other["batches"],
                                            lib["batches"])):
            raise AssertionError(f"phase 28 (b): the {what} feed's batches "
                                 "differ from the library's")
    traced_steps = P28_STEPS - 1
    counts = _p28_trace_counts(trace_dir)
    if DEV == "cuda":
        want = {"conv_bn_1x1": 36 * traced_steps,
                "conv_bn_kxk": 16 * traced_steps,
                "step_dispatch": traced_steps}
        got = {k: counts.get(k, 0) for k in want}
        if got != want:
            raise AssertionError(f"phase 28 (b): the trace holds {got}, "
                                 f"want {want}")
    else:
        say("phase 28 (b) the trace's kernels: not checked on the CPU")
    if counts.get("iteration", 0) < traced_steps - 1 or \
            counts.get("device_put", 0) < traced_steps - 1:
        raise AssertionError(f"phase 28 (b): the trace's step regions "
                             f"{counts}")
    say(f"phase 28 (b) {P28_STEPS} steps of the fused ResNet-50 (bf16, "
        f"batch {TRAIN_BATCH}) over a {x.nbytes / 1e6:.0f} MB f32 "
        f"ArrayDataSet: losses {['%.5f' % v for v in lib['loss']]} "
        f"bit-equal with the library, with BIGDL_TORCH_NO_NATIVE=1 and "
        f"traced; {len(lib['batches'])} batches bit-equal; conv_bn "
        f"launches {lib['launches']} each way [{smi}]")
    say(f"phase 28 (b) batch gather, ms a batch of {TRAIN_BATCH}: in the "
        f"feed (median of {len(lib['batches'])}) library "
        f"{lib['gather_ms']:.3f}, numpy {plain['gather_ms']:.3f}, "
        f"library traced {traced['gather_ms']:.3f}; alone (median of 16) "
        f"library {alone['library']:.3f}, numpy {alone['numpy']:.3f} "
        f"[{smi}]")
    say(f"phase 28 (b) step ms (median gap between loss reads, steps "
        f"3-{P28_STEPS}): library {lib['step_ms']:.3f}, numpy "
        f"{plain['step_ms']:.3f}, library traced {traced['step_ms']:.3f} "
        f"(traced/untraced {traced['step_ms'] / lib['step_ms']:.3f}); "
        f"wall of optimize() {lib['wall_s']:.2f} / {plain['wall_s']:.2f} / "
        f"{traced['wall_s']:.2f} s [{smi}]")
    say(f"phase 28 (b) the step profiler's trace ({counts['bytes'] / 1e6:.1f}"
        f" MB) over steps 2-{P28_STEPS}: conv_bn_1x1 {counts['conv_bn_1x1']}"
        f", conv_bn_kxk {counts['conv_bn_kxk']} kernels ({traced_steps} "
        f"steps x 36 / 16); annotate regions step_dispatch "
        f"{counts.get('step_dispatch', 0)}, iteration "
        f"{counts.get('iteration', 0)}, device_put "
        f"{counts.get('device_put', 0)} (the first traced step's began "
        f"before the trace)")
    return lib["launches"]


def _p28_sim_wait(started, smi) -> None:
    """(c): the simulator child's verdicts."""
    proc, out, log, t0 = started
    proc.wait(timeout=P28_SIM_TIMEOUT)
    log.close()
    wall = time.perf_counter() - t0
    if proc.returncode != 0 or not os.path.exists(out):
        with open(log.name) as f:
            raise AssertionError(f"phase 28 (c): the simulator exited "
                                 f"{proc.returncode}: {f.read()[-3000:]}")
    with open(out) as f:
        doc = json.load(f)
    bad = [(s["name"], [i["name"] for i in s["invariants"] if not i["ok"]])
           for s in doc["scenarios"] + doc["serve"] if not s["ok"]]
    if not doc["ok"] or bad or not doc["aggregation"]["ok"] or \
            len(doc["scenarios"]) != 7 or len(doc["serve"]) != 4 or \
            doc["hosts"] != P28_SIM_HOSTS:
        raise AssertionError(f"phase 28 (c): failed {bad}, aggregation "
                             f"{doc['aggregation']}")
    for sc in doc["scenarios"]:
        say(f"phase 28 (c) {sc['name']:12s} PASS at {sc['hosts']} hosts: "
            f"{sc['ticks']} ticks in {sc['wall_s']:.3f} s, world -> "
            f"{sc['final_world']}, {len(sc['decisions'])} decisions, "
            f"{sc['episodes']} episodes, {len(sc['invariants'])} invariants"
            f"; scrape worst {sc['scrape_worst_s'] * 1e3:.1f} ms")
    for sc in doc["serve"]:
        say(f"phase 28 (c) serve {sc['name']:16s} PASS: {sc['requests']} "
            f"requests, {sc['completed']} completed, {sc['shed']} shed, 0 "
            f"lost, amplification {sc['amplification']:.3f}, "
            f"{sc['wall_s']:.3f} s")
    say(f"phase 28 (c) python -m bigdl_tpu_torch.sim: 7 scenarios at "
        f"{doc['hosts']} hosts in {doc['total_wall_s']:.1f} s "
        f"({doc['jobs']} workers; "
        f"{sum(sc['wall_s'] for sc in doc['scenarios']):.1f} s summed), "
        f"{doc['decisions']} decisions, {doc['episodes']} episodes, "
        f"{doc['bundles']} bundles; {doc['aggregation']['detail']}; 4 serve "
        f"scenarios; its run {doc['run_wall_s']:.1f} s, collected {wall:.1f} s "
        f"after its start [{smi}]")


def phase_obs_native_sim(smi: str, p4_launches: dict) -> dict:
    """Phase 28 (see the docstring): needs phase 4's tokens and
    launches.  Returns (b)'s library arm's conv_bn launches."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="phase28_")
    sim = None
    try:
        # (b)'s timings first, on a quiet host; then the simulator's
        # workers beside (a), whose check is exact
        launches = _p28_native_feed(tmp, smi)
        sim = _p28_sim_start(tmp)
        _p28_served(smi, p4_launches)
        _p28_sim_wait(sim, smi)
    finally:
        if sim is not None:
            proc, _, log, _ = sim
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"phase 28 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# phase 29: the classic BigDL loop (update_output -> criterion forward /
# backward -> zero_grad_parameters -> backward -> update_parameters) on
# the flagship (5 f32 steps, lr) and on the fused ResNet-50 (3 f32
# steps, lr), each held to LocalOptimizer + SGD at f32 on the same
# weights and batches: losses and weights (relative L2) within
# P29_F32_TOL; the flagship's first step against the reference arm's
# gradients (LM_GRAD_REL_TOL) and, cast to bf16, its loss (LM_LOSS_TOL)
P29_LM_STEPS, P29_LM_LR = 5, 1e-3
P29_RESNET_STEPS, P29_RESNET_LR = 3, 0.1
P29_F32_TOL = 1e-5


def _p29_classic_step(model, crit, x, y, lr=None):
    """One step of the classic loop; returns the loss (host float)."""
    out = model.update_output(x)
    loss = crit.forward(out.float(), y)
    g = crit.backward(out.float(), y)
    model.zero_grad_parameters()
    model.backward(x, g)
    if lr is not None:
        model.update_parameters(lr)
    return float(loss)


def _p29_rel_l2(a: list, b: list) -> float:
    """Relative L2 of two lists of tensors taken as one vector."""
    num = sum(float((u.double() - v.double()).pow(2).sum())
              for u, v in zip(a, b))
    den = sum(float(v.double().pow(2).sum()) for v in b)
    return (num / max(den, 1e-300)) ** 0.5


def _p29_weights(model) -> list:
    return [p.detach().clone() for p in model.parameters()]


def _p29_optimizer_arm(model, x, y, batch, steps, lr):
    """LocalOptimizer + SGD(lr) at f32 over (x, y) in order, one batch a
    step; returns the losses."""
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger

    losses = _Losses()
    opt = LocalOptimizer(model, ArrayDataSet(x, y, batch, shuffle=False),
                         CrossEntropyCriterion(), batch_size=batch,
                         device=DEV)
    opt.set_optim_method(SGD(learningrate=lr)).set_train_summary(losses)
    opt.set_end_when(Trigger.max_iteration(steps)).optimize()
    torch.cuda.synchronize()
    return [losses.loss[n] for n in sorted(losses.loss)]


def _p29_flagship(smi) -> dict:
    """(a) the flagship by hand; returns its launches."""
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import _cuda

    n = P29_LM_STEPS * LM_BATCH
    x, y = _lm_data(n, LM_T)
    crit = CrossEntropyCriterion()
    model = _flagship(0)
    model.train()
    losses, per_step, grads0 = [], [], None
    _cuda.reset_launches()
    for i in range(P29_LM_STEPS):
        if i == 1:                      # steps 2-5 timed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        xb, yb = x[i * LM_BATCH:(i + 1) * LM_BATCH], \
            y[i * LM_BATCH:(i + 1) * LM_BATCH]
        before = dict(_cuda.launches)
        out = model.update_output(xb)
        loss = crit.forward(out.float(), yb)
        g = crit.backward(out.float(), yb)
        model.zero_grad_parameters()
        model.backward(xb, g)
        if i == 0:
            grads0 = {k: p.grad.detach().clone()
                      for k, p in model.named_parameters()}
        model.update_parameters(P29_LM_LR)
        losses.append(float(loss))
        per_step.append(tuple(_cuda.launches[k] - before[k] for k in
                              ("flash_fwd", "flash_bwd_dq",
                               "flash_bwd_dkv")))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / (P29_LM_STEPS - 1) * 1e3
    launches = {k: _cuda.launches[k] for k in
                ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    w_classic = _p29_weights(model)
    del model, out, g
    torch.cuda.empty_cache()
    if set(per_step) != {(8, 8, 8)}:
        raise AssertionError(f"phase 29 (a): rows 1-3 launched {per_step} "
                             "a step, want (8, 8, 8): the backward runs on "
                             "the kept graph")

    ref_model = _flagship(0)
    opt_losses = _p29_optimizer_arm(ref_model, x, y, LM_BATCH,
                                    P29_LM_STEPS, P29_LM_LR)
    w_opt = _p29_weights(ref_model)
    del ref_model
    torch.cuda.empty_cache()
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, opt_losses))
    w_gap = _p29_rel_l2(w_classic, w_opt)
    bit_equal = all(torch.equal(a, b) for a, b in zip(w_classic, w_opt))
    say(f"phase 29 (a) flagship classic loop, f32, {P29_LM_STEPS} steps of "
        f"B={LM_BATCH} T={LM_T} at lr {P29_LM_LR:g}: losses "
        f"{['%.6f' % v for v in losses]}; LocalOptimizer + SGD "
        f"{['%.6f' % v for v in opt_losses]}; worst relative loss gap "
        f"{loss_gap:.3e}, final weights relative L2 {w_gap:.3e} (limit "
        f"{P29_F32_TOL:g}; bit-equal {bit_equal}); rows 1-3 launches "
        f"{per_step[0]} a step, {launches} in all; {step_ms:.1f} ms a "
        f"step over steps 2-{P29_LM_STEPS} [{smi}]")
    if len(opt_losses) != P29_LM_STEPS or not all(np.isfinite(losses)) \
            or not loss_gap <= P29_F32_TOL or not w_gap <= P29_F32_TOL:
        raise AssertionError("phase 29 (a): the classic loop left "
                             "LocalOptimizer's trajectory")
    del w_classic, w_opt
    torch.cuda.empty_cache()

    # one step against the reference arm's gradients
    ref = _lm("reference", LM_T)
    ref.train()
    xb, yb = x[:LM_BATCH], y[:LM_BATCH]
    ref_loss = _p29_classic_step(ref, crit, xb, yb)
    rg = {k: p.grad for k, p in ref.named_parameters()}
    rel = {k: ((grads0[k] - rg[k]).norm() / rg[
        k[:-2] + "bq" if k.endswith(".bk") else k].norm()).item()
        for k in rg}
    worst = max(rel, key=rel.get)
    say(f"phase 29 (a) first step against the reference arm: loss "
        f"{losses[0]:.6f} / {ref_loss:.6f}; gradients of {len(rel)} "
        f"tensors, worst relative L2 {rel[worst]:.3e} at {worst} (limit "
        f"{LM_GRAD_REL_TOL:g})")
    if not rel[worst] <= LM_GRAD_REL_TOL:
        raise AssertionError(f"phase 29 (a): gradient {worst} off the "
                             f"reference arm by {rel[worst]:.3e}")
    del grads0, rg
    ref.to(torch.bfloat16)
    ref_bf16 = _p29_classic_step(ref, crit, xb, yb)
    del ref
    torch.cuda.empty_cache()
    ker = _flagship(0).to(torch.bfloat16)
    ker.train()
    before = dict(_cuda.launches)
    ker_bf16 = _p29_classic_step(ker, crit, xb, yb, P29_LM_LR)
    bf16_launches = tuple(_cuda.launches[k] - before[k] for k in
                          ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
    del ker
    torch.cuda.empty_cache()
    say(f"phase 29 (a) bf16 step: loss kernel {ker_bf16:.6f}, reference "
        f"{ref_bf16:.6f}, |gap| {abs(ker_bf16 - ref_bf16):.3e} (limit "
        f"{LM_LOSS_TOL:g}); rows 1-3 launches {bf16_launches}")
    if not abs(ker_bf16 - ref_bf16) <= LM_LOSS_TOL \
            or bf16_launches != (8, 8, 8):
        raise AssertionError("phase 29 (a): the bf16 step")
    return launches


def _p29_resnet(smi) -> dict:
    """(b) the fused ResNet-50 by hand; returns its launches."""
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import _cuda

    n = P29_RESNET_STEPS * TRAIN_BATCH
    rs = np.random.RandomState(3)
    x = rs.randn(n, 3, TRAIN_IMG, TRAIN_IMG).astype(np.float32)
    y = (rs.randint(0, TRAIN_CLASSES, n) + 1).astype(np.float32)
    crit = CrossEntropyCriterion()
    with _deterministic():
        model = _training_resnet50(fused=True)
        model.train()
        losses, per_step = [], []
        _cuda.reset_launches()
        for i in range(P29_RESNET_STEPS):
            if i == 1:                  # steps 2-3 timed
                torch.cuda.synchronize()
                t0 = time.perf_counter()
            sl = slice(i * TRAIN_BATCH, (i + 1) * TRAIN_BATCH)
            before = dict(_cuda.launches)
            losses.append(_p29_classic_step(model, crit, x[sl], y[sl],
                                            P29_RESNET_LR))
            per_step.append((_cuda.launches["conv_bn_1x1"]
                             - before["conv_bn_1x1"],
                             _cuda.launches["conv_bn_kxk"]
                             - before["conv_bn_kxk"]))
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / (P29_RESNET_STEPS - 1) * 1e3
        launches = {k: _cuda.launches[k]
                    for k in ("conv_bn_1x1", "conv_bn_kxk")}
        w_classic = _p29_weights(model)
        s_classic = [b.detach().clone() for b in model.buffers()]
        del model
        torch.cuda.empty_cache()
        opt_model = _training_resnet50(fused=True)
        s_init = [b.detach().clone() for b in opt_model.buffers()]
        opt_losses = _p29_optimizer_arm(opt_model, x, y, TRAIN_BATCH,
                                        P29_RESNET_STEPS, P29_RESNET_LR)
        w_opt = _p29_weights(opt_model)
        s_opt = [b.detach().clone() for b in opt_model.buffers()]
        del opt_model
        torch.cuda.empty_cache()
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, opt_losses))
    w_gap = _p29_rel_l2(w_classic, w_opt)
    bn_gap = _p29_rel_l2(s_classic, s_opt)
    bn_moved = _p29_rel_l2(s_opt, s_init)
    say(f"phase 29 (b) fused ResNet-50 classic loop, f32, "
        f"{P29_RESNET_STEPS} steps of B={TRAIN_BATCH} {TRAIN_IMG}x"
        f"{TRAIN_IMG} at lr {P29_RESNET_LR:g}, cuDNN deterministic: losses "
        f"{['%.6f' % v for v in losses]}; LocalOptimizer + SGD "
        f"{['%.6f' % v for v in opt_losses]}; worst relative loss gap "
        f"{loss_gap:.3e}, weights relative L2 {w_gap:.3e}, BN running "
        f"statistics relative L2 {bn_gap:.3e} (limit {P29_F32_TOL:g}; they "
        f"moved {bn_moved:.3e} from their start); conv_bn launches "
        f"{per_step[0]} a step, {launches} in all; {step_ms:.1f} ms a "
        f"step over steps 2-{P29_RESNET_STEPS} [{smi}]")
    if set(per_step) != {(36, 16)}:
        raise AssertionError(f"phase 29 (b): conv_bn launched {per_step} "
                             "a step, want (36, 16)")
    if len(opt_losses) != P29_RESNET_STEPS \
            or not all(np.isfinite(losses)) or not loss_gap <= P29_F32_TOL \
            or not w_gap <= P29_F32_TOL or not bn_gap <= P29_F32_TOL \
            or not bn_moved > 100 * P29_F32_TOL:
        raise AssertionError("phase 29 (b): the classic loop left "
                             "LocalOptimizer's trajectory or its BN "
                             "statistics")
    return launches


def _p29_weights_io(tmp) -> None:
    """(c) save_weights of a flagship, load_weights into another built
    from another seed: bit-equal logits."""
    from bigdl_tpu_torch.ops import _cuda

    a = _flagship(0)
    path = a.save_weights(os.path.join(tmp, "flagship"))
    b = _flagship(1)
    b.load_weights(path)
    x = torch.as_tensor(_lm_data(2, LM_T)[0], device=DEV)
    was = dict(_cuda.launches)
    with torch.no_grad():
        la, lb = a.evaluate()(x), b.evaluate()(x)
    torch.cuda.synchronize()
    _cuda.launches.update(was)          # a check, not the path
    same = torch.equal(la, lb)
    say(f"phase 29 (c) save_weights -> load_weights: "
        f"{len(a.get_weights())} tensors, "
        f"{os.path.getsize(path) / 2 ** 20:.1f} MiB; logits bit-equal "
        f"{same}")
    if not same:
        raise AssertionError("phase 29 (c): loaded weights give other "
                             "logits")


def _p29_shim() -> None:
    """(d) the classic Python-BigDL program through ``bigdl_torch`` on the
    card, against the same program written against the port."""
    import bigdl_torch.nn.criterion as SC
    import bigdl_torch.nn.layer as SL
    import bigdl_torch.optim.optimizer as SO
    import bigdl_torch.util.common as SU
    import bigdl_tpu_torch.nn as TN
    import bigdl_tpu_torch.optim as TO
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.engine import Engine
    from bigdl_tpu_torch.optim.evaluator import predict_class

    rs = np.random.RandomState(0)
    x = rs.randn(256, 4).astype(np.float32)
    y = (1 + (x[:, 0] > 0)).astype(np.float32)

    def run(layer, criterion, optimizer, max_epoch, init):
        init()
        RandomGenerator.RNG.set_seed(0)
        model = layer.Sequential().add(layer.Linear(4, 16)) \
            .add(layer.ReLU()).add(layer.Linear(16, 2)) \
            .add(layer.LogSoftMax())
        opt = optimizer.Optimizer(
            model=model, training_set=(x, y),
            criterion=criterion.ClassNLLCriterion(),
            optim_method=optimizer.SGD(learningrate=0.5),
            end_trigger=max_epoch(5), batch_size=64, distributed=False)
        losses = _Losses()
        opt.set_train_summary(losses)
        trained = opt.optimize()
        return trained, [losses.loss[k] for k in sorted(losses.loss)]

    trained, shim = run(SL, SC, SO, SO.MaxEpoch, SU.init_engine)
    acc = float((predict_class(trained, x) == y.astype(int)).mean())
    _, direct = run(TN, TN, TO, TO.Trigger.max_epoch, Engine.init)
    say(f"phase 29 (d) the classic program through bigdl_torch on "
        f"{DEV}: {len(shim)} losses, first {shim[0]:.6f}, last "
        f"{shim[-1]:.6f}, Top1 {acc:.4f}; equal to bigdl_tpu_torch's "
        f"{shim == direct}")
    if shim != direct or not acc > 0.95 or len(shim) != 20:
        raise AssertionError("phase 29 (d): the shim's program")


def _p29_lint() -> None:
    """(e) the port's static analysis over ``bigdl_tpu_torch``."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "bigdl_tpu_torch.analysis.lint"],
                          capture_output=True, text=True, timeout=120,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    tail = proc.stdout.strip().splitlines()[-1:] or [""]
    say(f"phase 29 (e) python -m bigdl_tpu_torch.analysis.lint: exit "
        f"{proc.returncode} in {secs:.2f} s ({tail[0]})")
    if proc.returncode != 0:
        raise AssertionError("phase 29 (e): lint findings\n"
                             + proc.stdout + proc.stderr)


def phase_classic(smi: str) -> dict:
    """Phase 29 (see the docstring); returns the launches of rows 1-5 on
    the classic loop, (a)'s and (b)'s."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    launches = _p29_flagship(smi)
    launches.update(_p29_resnet(smi))
    tmp = tempfile.mkdtemp(prefix="phase29_")
    try:
        _p29_weights_io(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    _p29_shim()
    _p29_lint()
    say(f"phase 29 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _has_pillow() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True



# the fused update's L2 clip at GPT-2-medium's shapes (the benchmark's)
FUSED_CLIP = 1.0


def _gpt2_medium_shapes() -> list:
    """GPT-2-medium's 389 parameter shapes as the benchmark builds it:
    token and position tables, 24 blocks (two LayerNorms, q/k/v/out
    projections, the MLP), the final LayerNorm and an untied head."""
    d, ff, vocab, pos = 1024, 4096, 50257, 1024
    shapes = [(vocab, d), (pos, d)]
    for _ in range(24):
        shapes += [(d,), (d,)] + [(d, d), (d,)] * 4 + [(d,), (d,)]
        shapes += [(ff, d), (ff,), (d, ff), (d,)]
    return shapes + [(d,), (d,), (vocab, d)]


def _fused_gap(got, want, start) -> float:
    """Largest |got - want| beyond one f32 eps of max|want|, over the
    largest step |want - start|, across tensors."""
    eps = float(torch.finfo(torch.float32).eps)
    worst = 0.0
    for a, b, a0 in zip(got, want, start):
        over = (a - b).abs().max().item() - eps * b.abs().max().item()
        step = (b - a0).abs().max().item()
        worst = max(worst, max(over, 0.0) / max(step, 1e-30))
    return worst


def _p30_gpt2_medium() -> dict:
    """(a): times and the plain comparison at GPT-2-medium's shapes."""
    from bigdl_tpu_torch.ops import fused_update as F
    from bigdl_tpu_torch.optim import Adam
    from bigdl_tpu_torch.optim.optimizer import _GradClipper, _where

    shapes = _gpt2_medium_shapes()
    n = sum(int(np.prod(sh)) for sh in shapes)
    gen = torch.Generator(device=DEV).manual_seed(30)

    def make(scale):
        return [torch.randn(sh, generator=gen, device=DEV) * scale
                for sh in shapes]

    g, p, m = make(1e-3), make(0.02), make(1e-3)
    v = [(a * a).mul_(0.1) for a in make(1e-3)]
    method = Adam(learningrate=3e-4)
    st = method.init_state(p[:1])
    st.update(m=m, v=v, neval=torch.full((), 5.0, device=DEV))
    loss = torch.tensor(2.5, device=DEV)
    frozen = [False] * len(shapes)
    t = st["neval"] + 1.0
    lr, bc1, bc2 = (method.current_rate(st), 1 - method.beta1 ** t,
                    1 - method.beta2 ** t)
    kw = dict(beta1=method.beta1, beta2=method.beta2, eps=method.epsilon,
              gate=True)

    def both(cls=F.adam_update, pp=p, mm=m, vv=v):
        upd = cls(g, pp, mm, vv, frozen, FUSED_CLIP, None)
        upd.stats(loss)
        upd.apply(lr, bc1, bc2, **kw)

    clipper = _GradClipper()
    clipper.l2_norm_clip = FUSED_CLIP

    def chain():
        gg = clipper(g)
        new_p, new_opt = method.step(gg, p, st)
        ok = torch.isfinite(loss)
        for a in gg:
            ok = ok & torch.isfinite(a).all()
        new_p = _where(ok, new_p, p)
        _where(ok, new_opt, st)
        for a, b in zip(p, new_p):
            a.copy_(b)

    upd = F.adam_update(g, p, m, v, frozen, FUSED_CLIP, None)
    # each pass on the device alone; a call with its table (built on
    # the host each step) back to back, where the card waits for the
    # host only if the table takes longer than the two passes
    row = dict(
        stats_device_ms=time_ms(lambda: upd.stats(loss), device_only=True),
        apply_device_ms=time_ms(lambda: upd.apply(lr, bc1, bc2, **kw),
                                device_only=True),
        ms=time_ms(both),
        plain_ms=time_ms(lambda: both(F.PlainAdamUpdate), reps=5, warmup=1),
        per_tensor_ms=time_ms(chain, reps=5, warmup=1))
    del upd
    torch.cuda.empty_cache()
    nbytes = 32 * n
    row.update(device_ms=row["stats_device_ms"] + row["apply_device_ms"],
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
               values=n, tensors=len(shapes))
    row["share"] = row["bound_ms"] / row["device_ms"]
    # the kernel against the plain version from one start
    start = [[a.clone() for a in x] for x in (p, m, v)]
    k_out = [[a.clone() for a in x] for x in start]
    both(F.KernelAdamUpdate, *k_out)
    both(F.PlainAdamUpdate, p, m, v)
    torch.cuda.synchronize()
    row["plain_gap"] = max(_fused_gap(a, b, c) for a, b, c in
                           zip(k_out, (p, m, v), start))
    say(f"phase 30 (a) fused Adam, GPT-2-medium's {len(shapes)} tensors "
        f"({n} f32), L2 clip {FUSED_CLIP:g}, guard: pass 1 "
        f"{row['stats_device_ms']:.4f} ms and pass 2 "
        f"{row['apply_device_ms']:.4f} ms on the device, together "
        f"{row['device_ms']:.4f}; with the table {row['ms']:.4f} a call; "
        f"bound {row['bound_ms']:.4f} ms (bytes), share "
        f"{row['share']:.3f}; plain {row['plain_ms']:.2f} ms, per-tensor "
        f"chain {row['per_tensor_ms']:.2f} ms a call; kernel off plain "
        f"{row['plain_gap']:.2e} of the largest step (limit 1e-5)")
    if not row["plain_gap"] <= 1e-5:
        raise AssertionError(f"fused Adam off its plain version: "
                             f"{row['plain_gap']:.3e}")
    return row


def _p30_trainer_arm(fused: bool, x, y, steps: int):
    import shutil
    import tempfile

    import bigdl_tpu_torch.nn as N
    from bigdl_tpu_torch import obs
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.dataset import ArrayDataSet
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger

    RandomGenerator.RNG.set_seed(30)
    model = (N.Sequential().add(N.Linear(256, 512)).add(N.Tanh())
             .add(N.Linear(512, 10)).add(N.LogSoftMax()))
    opt = LocalOptimizer(model, ArrayDataSet(x, y, 64, shuffle=False),
                         N.ClassNLLCriterion(), batch_size=64, device=DEV)
    opt.set_optim_method(Adam(learningrate=1e-3))
    opt.set_gradient_clipping_by_l2_norm(FUSED_CLIP)
    if not fused:
        opt._fused_adam_now = lambda *a: False
    rec = {}

    class Losses:
        def add_scalar(self, tag, value, step):
            if tag == "Loss":
                rec[step] = value

    opt.set_train_summary(Losses())
    _cuda.reset_launches()
    # the obs tracer on: each step's step.update span says its path
    tmp = tempfile.mkdtemp(prefix="phase30_")
    os.environ["BIGDL_TORCH_TRACE_DIR"] = tmp
    obs.reset()
    try:
        opt.set_end_when(Trigger.max_iteration(steps)).optimize()
        torch.cuda.synchronize()
        paths = [r["attrs"].get("fused") for r in obs.get_tracer().recent()
                 if r.get("kind") == "span" and r["name"] == "step.update"]
    finally:
        os.environ.pop("BIGDL_TORCH_TRACE_DIR", None)
        obs.reset()
        shutil.rmtree(tmp, ignore_errors=True)
    return ([rec[k] for k in sorted(rec)],
            [q.detach().clone() for q in opt._param_leaves()[1]],
            _cuda.launches["fused_adam"], opt, paths)


def phase_fused_update(smi: str) -> dict:
    """Phase 30 (see the docstring); returns the kernels line's row."""
    t_phase = time.perf_counter()
    row = _p30_gpt2_medium()
    steps = 4
    rs = np.random.RandomState(30)
    x = rs.randn(steps * 64, 256).astype(np.float32)
    y = (rs.randint(0, 10, steps * 64) + 1).astype(np.float32)
    losses, params, launches, opt, paths = _p30_trainer_arm(True, x, y,
                                                            steps)
    p_losses, p_params, p_launches, _, p_paths = _p30_trainer_arm(
        False, x, y, steps)
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, p_losses))
    num = sum(float(torch.sum((a - b) ** 2))
              for a, b in zip(params, p_params))
    p_rel = (num / sum(float(torch.sum(b ** 2)) for b in p_params)) ** 0.5
    # a NaN batch through the fused step: everything kept
    names, live, _ = opt._param_leaves()
    st = opt.optim_method.state
    before = [a.detach().clone() for a in live + st["m"] + st["v"]]
    nan_x = torch.full((64, 256), float("nan"), device=DEV)
    new, _, ok = opt._train_step(names, live, st, nan_x,
                                 torch.ones(64, device=DEV), None, True, 0)
    kept = (not bool(ok) and float(new["neval"]) == float(st["neval"])
            and all(torch.equal(a, b.detach()) for a, b in
                    zip(before, live + st["m"] + st["v"])))
    say(f"phase 30 (b) LocalOptimizer, Adam, L2 clip, {steps} steps: "
        f"fused_adam launches {launches} (per-tensor arm {p_launches}); "
        f"losses {['%.5f' % v for v in losses]}, against the per-tensor "
        f"path {loss_rel:.3e}, weights L2 {p_rel:.3e} (limit {F32_TOL:g}); "
        f"step.update spans' fused {paths} / {p_paths}; a NaN batch kept "
        f"p, m, v and neval: {kept}")
    if launches != 2 * steps or p_launches != 0:
        raise AssertionError(f"fused_adam launched {launches} / "
                             f"{p_launches}, want {2 * steps} / 0")
    if paths != [True] * steps or p_paths != [False] * steps:
        raise AssertionError(f"step.update spans' fused: {paths} / "
                             f"{p_paths}")
    if not (loss_rel <= F32_TOL and p_rel <= F32_TOL and kept):
        raise AssertionError("the fused trainer path is off the per-tensor "
                             "one")
    print(smi, flush=True)
    say(f"phase 30 took {time.perf_counter() - t_phase:.1f} s")
    return dict(name="fused_adam", route="cuda",
                source="bigdl_tpu_torch/csrc/fused_adam.cu",
                replaces="none: XLA fused the JAX package's jitted update",
                shape=f"GPT-2-medium, {row['tensors']} tensors, "
                      f"{row['values']} f32, Adam + L2 clip + guard",
                launches_per_step=launches // steps, **row,
                trainer_launches=launches)


def _p31_flash() -> list:
    """Phase 31 (a): rows 1-3 at (192, 128) and the cell's shape against
    the plain versions, timed; returns their three kernels-line rows."""
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.ops.attention import (flash_attention,
                                               flash_attention_plain,
                                               flash_backward,
                                               flash_bwd_dkv_plain,
                                               flash_bwd_dq_plain)

    b, h, t = MLA_B, MLA_H, MLA_T
    dqk, dv = MLA["nope"] + MLA["rope"], MLA["dv"]
    bh, scale, kw = b * h, dqk ** -0.5, dict(causal=True)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(31)
    q, k = (torch.randn((b, h, t, dqk), generator=gen, device=DEV)
            .bfloat16() for _ in range(2))
    v, g = (torch.randn((b, h, t, dv), generator=gen, device=DEV)
            .bfloat16() for _ in range(2))
    out, lse = flash_attention(q, k, v, scale=scale, with_lse=True, **kw)
    out2, lse2 = flash_attention(q, k, v, scale=scale, with_lse=True, **kw)
    fq, fk, fv, fg = (x.reshape(bh, t, -1) for x in (q, k, v, g))
    fo = out.reshape(bh, t, dv)
    got = flash_backward(fq, fk, fv, fo, lse, fg, scale=scale, **kw)
    again = flash_backward(fq, fk, fv, fo, lse, fg, scale=scale, **kw)
    torch.cuda.synchronize()
    name = f"(192, 128) B={b} H={h} T={t} bf16 causal"
    if not (torch.equal(out, out2) and torch.equal(lse, lse2)
            and all(torch.equal(x, y) for x, y in zip(got, again))):
        raise AssertionError(f"{name}: two runs on one input differ")
    del out2, lse2, again
    ref, ref_lse = flash_attention_plain(fq, fk, fv, scale=scale, **kw)
    delta = (fg.float() * fo.float()).sum(dim=-1)
    want = (flash_bwd_dq_plain(fq, fk, fv, fg, lse, delta, scale=scale, **kw),
            *flash_bwd_dkv_plain(fq, fk, fv, fg, lse, delta, scale=scale,
                                 **kw))
    errs = {}
    for which, x, w in (("o", fo, ref), ("dq", got[0], want[0]),
                        ("dk", got[1], want[1]), ("dv", got[2], want[2])):
        if x.dtype != torch.bfloat16 or x.shape != w.shape:
            raise AssertionError(f"{name} {which}: {x.dtype} {x.shape}")
        errs[which] = (x.float() - w.float()).abs().max().item()
        check(f"phase 31 {name} {which}", errs[which],
              _bf16_ulp(w.float().abs().max().item()))
    lse_err = (lse - ref_lse).abs().max().item()
    check(f"phase 31 {name} lse", lse_err, F32_TOL)
    say(f"phase 31 (a) {name}: max abs err o {errs['o']:.3e}, dq "
        f"{errs['dq']:.3e}, dk {errs['dk']:.3e}, dv {errs['dv']:.3e} (each "
        f"within one bf16 ulp of its largest |value|), lse {lse_err:.3e}; "
        "bit-equal run to run")
    del ref, ref_lse, want, got
    torch.cuda.empty_cache()

    dq, dk, dvv = (torch.empty_like(x) for x in (fq, fk, fv))
    launch = dict(
        flash_fwd=lambda: _cuda.launch_flash_fwd(
            fq, fk, fv, fo, lse, scale=scale, **kw),
        flash_bwd_dq=lambda: _cuda.launch_flash_bwd_dq(
            fq, fk, fv, fg, lse, delta, dq, scale=scale, **kw),
        flash_bwd_dkv=lambda: _cuda.launch_flash_bwd_dkv(
            fq, fk, fv, fg, lse, delta, dk, dvv, scale=scale, **kw))
    plain = dict(
        flash_fwd=lambda: flash_attention_plain(fq, fk, fv, scale=scale,
                                                **kw),
        flash_bwd_dq=lambda: flash_bwd_dq_plain(fq, fk, fv, fg, lse, delta,
                                                scale=scale, **kw),
        flash_bwd_dkv=lambda: flash_bwd_dkv_plain(fq, fk, fv, fg, lse, delta,
                                                  scale=scale, **kw))
    pairs = bh * t * (t + 1) / 2
    rows_b = 2 * bh * t * 4                     # lse and delta read
    cost = {  # (FLOPs a causal pair, bytes: inputs read, outputs written)
        "flash_fwd": (2 * (dqk + dv),
                      bh * t * (2 * dqk + 2 * dv) * 2 + bh * t * 4),
        "flash_bwd_dq": (2 * (2 * dqk + dv),
                         bh * t * (3 * dqk + 2 * dv) * 2 + rows_b),
        "flash_bwd_dkv": (4 * (dqk + dv),
                          bh * t * (3 * dqk + 3 * dv) * 2 + rows_b)}
    err_of = {"flash_fwd": errs["o"], "flash_bwd_dq": errs["dq"],
              "flash_bwd_dkv": max(errs["dk"], errs["dv"])}
    rows = []
    for kern, (per_pair, nbytes) in cost.items():
        flops = per_pair * pairs
        dev_ms = time_ms(launch[kern], reps=10, device_only=True)
        plain_ms = time_ms(plain[kern], reps=2, warmup=1)
        bound_ms, by = bound(nbytes, flops, torch.bfloat16)
        row = dict(name=f"{kern}_192x128", route="cuda",
                   source=f"bigdl_tpu_torch/csrc/{kern}.cu <192, 128>",
                   replaces="none: the JAX package has no latent attention",
                   shape=f"B={b} H={h} T={t} (192, 128) bf16 causal",
                   max_abs_err_bf16=err_of[kern],
                   device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                   bound_by=by, tflops=flops / (dev_ms * 1e-3) / 1e12,
                   share=bound_ms / dev_ms)
        say(f"phase 31 (a) {kern} (192, 128): {dev_ms:.4f} ms on the "
            f"device ({row['tflops']:.1f} TFLOP/s, {row['share']:.3f} of "
            f"the bound {bound_ms:.4f} ms by {by}); plain {plain_ms:.2f} ms")
        rows.append(row)
    return rows


def _p31_moe() -> None:
    """Phase 31 (b): one SigmoidMoE layer at the cell's widths, with no
    host sync, against its plain f32 version."""
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import plain_deepseek_v3 as P
    from bigdl_tpu_torch.parallel.moe import SigmoidMoE

    d, first = MLA["dim"], MLA["held"]
    gen = torch.Generator(device=DEV)
    gen.manual_seed(312)
    layer = SigmoidMoE(d, MLA["hidden"], MLA["experts"], MLA["top_k"],
                       MLA["shared"], MLA["scaling"], first, MLA["held"],
                       0.02, gen)
    layer.to(DEV)
    with torch.no_grad():
        layer.router.bias.copy_(torch.randn(MLA["experts"], generator=gen,
                                            device=DEV) * 0.1)
    x = torch.randn(1, MLA_T, d, generator=gen, device=DEV).bfloat16() \
        .requires_grad_(True)
    params = {n: p if getattr(p, "keep_f32", False) else p.bfloat16()
              for n, p in layer.named_parameters()}
    torch.func.functional_call(layer, params, (x,)).float().sum()  # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = torch.func.functional_call(layer, params, (x,))
        grads = torch.autograd.grad(out.float().square().mean(),
                                    [x] + list(params.values()))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(gr).all()) for gr in grads)
    cfg = {"router_experts": MLA["experts"], "num_experts_per_tok":
           MLA["top_k"], "routed_scaling_factor": MLA["scaling"],
           "first_held_expert": first, "n_routed_experts": MLA["held"]}
    w = {"h1.mlp." + n: p.detach().float() for n, p in params.items()}
    with torch.no_grad():
        ref = P.moe(x.detach().float(), w, "h1.", layer.router.bias, cfg)
    err = (out.detach().float() - ref).abs().max().item()
    mag = ref.abs().max().item()
    with torch.no_grad():
        idx = layer.route(x.detach().reshape(-1, d))[0]
    held = int(((idx >= first) & (idx < first + MLA["held"])).sum())
    say(f"phase 31 (b) SigmoidMoE at Moonlight's widths, {MLA_T} bf16 "
        f"tokens, experts {first}-{first + MLA['held'] - 1} held "
        f"({held} of {MLA_T * MLA['top_k']} assignments): forward and "
        f"backward with no host sync; max abs err {err:.3e} against the "
        f"plain f32 layer, largest |y| {mag:.3e} (limit {MOE_REL_TOL:g} of "
        f"it); gradients finite: {finite}")
    if not (err <= MOE_REL_TOL * mag and finite and held > 0):
        raise AssertionError("phase 31 (b): the MoE layer is off its plain "
                             "version")


def _p31_arm(impl: str, x, y):
    """Phase 31 (c): ``DeepseekV3LM`` trained by ``LocalOptimizer``;
    returns (losses, launches)."""
    from bigdl_tpu_torch.dataset.dataset import ArrayDataSet
    from bigdl_tpu_torch.models.deepseek_v3 import DeepseekV3LM
    from bigdl_tpu_torch.nn.criterion import CrossEntropyCriterion
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.optim import Adam, LocalOptimizer, Trigger
    from bigdl_tpu_torch.parallel.moe import SigmoidMoE

    m = MLA
    model = DeepseekV3LM(
        m["vocab"], m["dim"], MLA_LAYERS, 1, m["heads"], m["nope"],
        m["rope"], m["dv"], m["rank"], m["dense"], m["hidden"],
        m["experts"], m["top_k"], m["shared"], m["scaling"], 0, m["held"],
        m["theta"], 1e-5, 1e-6, attn_impl=impl, seed=31, device=DEV)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(313)
    with torch.no_grad():
        for i in range(MLA_LAYERS):
            mlp = model.child(f"h{i}").mlp
            if isinstance(mlp, SigmoidMoE):
                mlp.router.bias.copy_(torch.randn(
                    m["experts"], generator=gen, device=DEV) * 0.1)
    losses = _Losses()
    opt = LocalOptimizer(model, ArrayDataSet(x, y, MLA_B, shuffle=False),
                         CrossEntropyCriterion(), batch_size=MLA_B,
                         device=DEV)
    opt.set_optim_method(Adam(learningrate=3e-4))
    opt.set_compute_dtype("bfloat16")
    opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.set_train_summary(losses)
    _cuda.reset_launches()
    opt.set_end_when(Trigger.max_iteration(MLA_STEPS)).optimize()
    torch.cuda.synchronize()
    loss = [losses.loss[n] for n in sorted(losses.loss)]
    if len(loss) != MLA_STEPS or not all(np.isfinite(loss)):
        raise AssertionError(f"phase 31 (c) {impl} arm: losses {loss}")
    return loss, dict(_cuda.launches)


def phase_mla(smi: str) -> list:
    """Phase 31 (see the docstring); returns the kernels line's rows of
    rows 1-3 at (192, 128), each with its launches in (c)."""
    t_phase = time.perf_counter()
    rows = _p31_flash()
    torch.cuda.empty_cache()
    _p31_moe()
    torch.cuda.empty_cache()
    rs = np.random.RandomState(31)
    x = rs.randint(0, MLA["vocab"], (MLA_STEPS, MLA_T)).astype(np.int64)
    y = (rs.randint(0, MLA["vocab"], (MLA_STEPS, MLA_T)) + 1) \
        .astype(np.float32)
    arms = {}
    for impl in ("reference", "kernel"):
        arms[impl] = _p31_arm(impl, x, y)
        torch.cuda.empty_cache()
    (r_loss, r_launch), (k_loss, k_launch) = arms["reference"], arms["kernel"]
    gaps = [abs(a - b) for a, b in zip(k_loss, r_loss)]
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    say(f"phase 31 (c) DeepseekV3LM, {MLA_LAYERS} layers (1 dense), "
        f"1 x {MLA_T} tokens, bf16 Adam, {MLA_STEPS} steps: losses kernel "
        f"{['%.5f' % v for v in k_loss]}, reference "
        f"{['%.5f' % v for v in r_loss]}, gaps {['%.2e' % v for v in gaps]} "
        f"(limit {LM_LOSS_TOL:g}); launches kernel arm "
        f"{[k_launch[k] for k in flash]} + fused_adam "
        f"{k_launch['fused_adam']}, reference arm "
        f"{[r_launch[k] for k in flash]}")
    want = MLA_LAYERS * MLA_STEPS
    if [k_launch[k] for k in flash] != [want] * 3 \
            or any(r_launch[k] for k in flash) \
            or k_launch["fused_adam"] != 2 * MLA_STEPS:
        raise AssertionError(f"phase 31 (c) launches {k_launch} / "
                             f"{r_launch}, want {want} of each flash kernel")
    if not all(gp <= LM_LOSS_TOL for gp in gaps):
        raise AssertionError("phase 31 (c): the arms' losses differ")
    for row in rows:
        row["launches"] = k_launch[row["name"][:-len("_192x128")]]
    print(smi, flush=True)
    say(f"phase 31 took {time.perf_counter() - t_phase:.1f} s")
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import bigdl_tpu_torch  # noqa: F401  (fails where the checkout is missing)

    if sys.argv[1:2] == ["--tp-rank"]:
        return _tp_rank_main(sys.argv[2:])
    t_start = time.perf_counter()

    smi = phase_device()
    phase_build()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    kernels = [phase_flash(gen), phase_decode(gen)]
    model, launches, serve_stats = phase_main_path()
    p4_launches = dict(launches)
    phase_profile(model)
    del model
    torch.cuda.empty_cache()
    kernels += phase_conv_bn(gen)
    opt, train_launches = phase_training()
    phase_train_profile(opt)
    launches.update({k: train_launches[k]
                     for k in ("conv_bn_1x1", "conv_bn_kxk")})
    del opt
    torch.cuda.empty_cache()
    kernels += phase_flash_bwd(gen)
    opt, lm_launches = phase_lm_training()
    phase_train_profile(opt, 12, "kernel-arm transformer training step")
    launches.update({k: lm_launches[k]
                     for k in ("flash_bwd_dq", "flash_bwd_dkv")})
    del opt
    torch.cuda.empty_cache()
    phase_ptb()
    phase_lenet()
    phase_imagenet(smi)
    phase_caffe(smi)
    phase_serving_http(smi, serve_stats["ttft_p50_s"])
    phase_optim(smi)
    phase_text_cnn(smi)
    phase_router(smi, serve_stats["tokens_per_s"])
    p21 = phase_image_pipeline(smi)
    say(f"phase 21 (a) conv_bn launches {p21}")
    # rows 4-5's launches: this slice's main path, phase 22 (a)
    launches.update(phase_distri_resilience(smi))
    phase_item16(smi)
    offsets = phase_seq_tuner(smi)
    tp_rows = phase_tp_moe(smi, serve_stats)
    phase_front_ends(smi)
    phase_fleet(smi)
    # rows 4-5's launches: phase 28 (b), then this slice's main path,
    # phase 29 (with rows 1-3's)
    launches.update(phase_obs_native_sim(smi, p4_launches))
    launches.update(phase_classic(smi))
    fused = phase_fused_update(smi)
    kernels.append(fused)
    launches["fused_adam"] = fused["trainer_launches"]
    mla = phase_mla(smi)
    kernels += mla
    launches.update({k["name"]: k["launches"] for k in mla})
    for k in kernels:
        k.update(offsets.get(k["name"], {}))
        k.update(tp_rows.get(k["name"], {}))
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    say("phase 9 kernels")
    print(json.dumps({"kernels": kernels}), flush=True)
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
