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
9. the kernels line, last: one JSON object listing each kernel with its
   launches on its own path (phase 4, the fused arm of phase 7, or the
   kernel arm of phase 11) and its numbers from phase 3, 6 or 10.

The last line is ``{"ok": true, "device": {...}}``, after the card's
name and power limit and the script's total seconds.
"""

from __future__ import annotations

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
# head dim D, the 1x1 conv's pixels per B copy VEC; None: not templated
# on an integer)
TENSOR_CORE_KERNELS = {"flash_fwd": ("D", (32, 64, 128), (32, 64, 128)),
                       "flash_bwd_dq": ("D", (32, 64, 128), (32, 64, 128)),
                       "flash_bwd_dkv": ("D", (32, 64, 128), (32, 64, 128)),
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
# the device of the conv_bn, flash backward and training phases
DEV = "cuda"
# clock cycles of the busy wait before a device-only timing (some 2 ms at
# the H100's 1.98 GHz boost clock): longer than the host takes to queue
# any call timed that way
SLEEP_CYCLES = 4_000_000


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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
    from bigdl_tpu_torch import config

    tool = os.path.join(os.path.dirname(config.nvcc_path()), "cuobjdump")
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
                raise AssertionError(f"{name} bf16 {arg}={d}: ptxas reports "
                                     f"{regs} registers, {spill} bytes of "
                                     "spills")
            at = "" if d is None else f" {arg}={d}"
            say(f"phase 2 {name} bf16{at}: "
                f"{hmma[(f'{name}_bf16_kernel', d)]} bf16 HMMA in its SASS "
                f"(f32 kernel: 0); ptxas: {regs} registers, {spill} bytes "
                "spilled")


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


def phase_main_path() -> dict:
    from bigdl_tpu_torch.common import RandomGenerator
    from bigdl_tpu_torch.models.transformer import build_transformer_lm
    from bigdl_tpu_torch.ops import _cuda
    from bigdl_tpu_torch.serving.engine import LMEngine

    RandomGenerator.RNG.set_seed(0)
    model = build_transformer_lm(8192, dim=512, n_head=8, n_layer=8,
                                 max_len=512, attn_impl="kernel",
                                 device="cuda")
    eng = LMEngine(model, max_batch=8, page_size=16, decode_attn="kernel",
                   device="cuda")
    rs = np.random.RandomState(0)
    prompt_lens = [100, 400, 127, 260, 200, 350, 256, 130, 300, 120, 390,
                   250]
    prompts = [rs.randint(0, 8192, n) for n in prompt_lens]
    buckets = sorted({eng._bucket(n) for n in prompt_lens})
    new_tokens = 32

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
    say(f"phase 4 served {st['requests']} requests, {st['tokens']} tokens "
        f"in {wall:.3f} s; prefill buckets {buckets}; steps {st['steps']}; "
        f"preemptions {st['preemptions']}; launches {launches}")
    say(f"phase 4 ttft p50 {st['ttft_p50_s'] * 1e3:.2f} ms, "
        f"tokens/s {st['tokens_per_s']:.1f}, decode step "
        f"{st['decode_ms_mean']:.3f} ms mean")
    if any(r.error or len(r.tokens) != new_tokens for r in reqs):
        raise AssertionError("a request failed or came back short")

    worst_gap, exact, prefix = 0.0, 0, []
    with torch.no_grad():
        for p, r in zip(prompts, reqs):
            seq = torch.tensor(list(p) + r.tokens, device="cuda")[None]
            logits = model(seq[:, :-1])[0].float()
            if not torch.isfinite(logits).all():
                raise AssertionError("non-finite logits in the forward")
            rows = logits[len(p) - 1:]
            got = rows.gather(1, torch.tensor(r.tokens, device="cuda")[:, None])
            gap = (rows.max(dim=1).values - got[:, 0]).max().item()
            worst_gap = max(worst_gap, gap)
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
    return model, launches


def phase_profile(model) -> None:
    """Device busy share and top kernels over ten decode steps of a
    full batch (8 slots, 256-token prompts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.serving.engine import LMEngine

    eng = LMEngine(model, max_batch=8, page_size=16, decode_attn="kernel",
                   device="cuda")
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
    kernels_before = dict(_cuda.launches)
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
    if dict(_cuda.launches) != kernels_before:
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


def _has_pillow() -> bool:
    try:
        import PIL  # noqa: F401
    except ImportError:
        return False
    return True


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import bigdl_tpu_torch  # noqa: F401  (fails where the checkout is missing)

    t_start = time.perf_counter()

    smi = phase_device()
    phase_build()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    kernels = [phase_flash(gen), phase_decode(gen)]
    model, launches = phase_main_path()
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
    for k in kernels:
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
