#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (``bigdl_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It needs CUDA and exits non-zero without it.  Phases, each printed as
it runs; any failure exits non-zero:

1. device: the card's name and power limit (``nvidia-smi``); f32
   matmuls are set to full f32 (no TF32);
2. build: ``nvcc`` compiles every kernel under ``bigdl_tpu_torch/csrc``
   for sm_90a, all sources at once;
3. kernels: each kernel against its plain PyTorch version on the card
   at the main path's shapes, with the max abs error, the kernel's
   time, the plain version's time, its bound, and a PyTorch library
   call's time where one computes the same function;
4. main path: the flagship TransformerLM (vocab 8192, dim 512, 8 heads,
   8 layers, max_len 512, random f32 weights from a seed) served by
   ``LMEngine`` with the flash prefill kernel and the paged decode
   kernel: 12 requests, prompts of 100-400 tokens, 32 new tokens each,
   temperature 0.  Every generated token is checked against a full
   forward of the model over the same tokens;
5. where the decode step's time goes: ``torch.profiler`` over ten
   steps of a full batch, device busy share and the top kernels;
6. the kernels line: one JSON object listing each kernel with its
   launches in phase 4 and its numbers from phase 3.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# max abs error limits against the plain versions (f32: 1e-5 holds
# with a 20x margin on the card; bf16: one bf16 ulp of |o| < 4)
F32_TOL = 1e-5
BF16_TOL = 2e-2
# published H100 SXM peaks (dense): HBM bytes/s; f32 on the CUDA cores
# and bf16 on the tensor cores, FLOP/s
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

FLASH_REPLACES = "bigdl_tpu/ops/attention.py:120"
DECODE_REPLACES = "bigdl_tpu/ops/decode_attention.py:205"


def say(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
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


def phase_build() -> None:
    from bigdl_tpu_torch.ops import _cuda

    t0 = time.perf_counter()
    compile_s = _cuda.build()
    say(f"phase 2 build: nvcc {compile_s:.1f} s for "
        f"{', '.join(_cuda.SOURCES.values())} (in parallel), "
        f"{time.perf_counter() - t0:.1f} s with loading")


def _flash_case(t, d, dtype, causal, gen):
    from bigdl_tpu_torch.ops.attention import (flash_attention,
                                               flash_attention_plain)

    q, k, v = (torch.randn((1, 8, t, d), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    torch.cuda.synchronize()
    scale = d ** -0.5
    ref, ref_lse = flash_attention_plain(
        q.reshape(8, t, d), k.reshape(8, t, d), v.reshape(8, t, d),
        causal=causal, scale=scale)
    err = (out.reshape(8, t, d).float() - ref.float()).abs().max().item()
    lse_err = (lse - ref_lse).abs().max().item()
    return err, lse_err


def phase_flash(gen) -> dict:
    from bigdl_tpu_torch.ops.attention import (flash_attention,
                                               flash_attention_plain)

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    # the prefill shapes (B=1, H=8, D=64, causal) plus ragged and other
    # head widths the kernel takes
    cases = [(t, 64, dt, True) for dt in (torch.float32, torch.bfloat16)
             for t in (128, 256, 512)]
    cases += [(200, 64, torch.float32, False), (131, 32, torch.float32, True),
              (96, 128, torch.bfloat16, False)]
    for t, d, dt, causal in cases:
        err, lse_err = _flash_case(t, d, dt, causal, gen)
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        check(f"flash_fwd T={t} D={d} {dt} causal={causal}", err, tol)
        check(f"flash_fwd lse T={t} D={d} {dt}", lse_err, F32_TOL)
        worst[dt] = max(worst[dt], err)
        say(f"phase 3 flash_fwd T={t} D={d} {str(dt)[6:]} causal={causal}: "
            f"max abs err {err:.3e} (lse {lse_err:.3e})")
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        for t in (128, 256, 512):
            q, k, v = (torch.randn((1, 8, t, 64), generator=gen,
                                   device="cuda").to(dt) for _ in range(3))
            qr, kr, vr = (x.reshape(8, t, 64) for x in (q, k, v))
            ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
            plain = time_ms(lambda: flash_attention_plain(
                qr, kr, vr, causal=True, scale=0.125))
            lib = time_ms(lambda: torch.nn.functional
                          .scaled_dot_product_attention(q, k, v,
                                                        is_causal=True))
            itemsize = q.element_size()
            nbytes = 4 * 8 * t * 64 * itemsize        # q, k, v read; o written
            flops = 4 * 8 * 64 * t * (t + 1) / 2     # causal pairs only
            b_ms, b_by = bound(nbytes, flops, dt)
            say(f"phase 3 flash_fwd time T={t} {str(dt)[6:]}: kernel "
                f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
                f"bound {b_ms:.5f} ms ({b_by})")
            rows[(dt, t)] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=b_ms, bound_by=b_by)
    main = rows[(torch.float32, 512)]
    return dict(name="flash_fwd", route="cuda",
                source="bigdl_tpu_torch/csrc/flash_fwd.cu",
                replaces=FLASH_REPLACES,
                max_abs_err=worst[torch.float32],
                max_abs_err_bf16=worst[torch.bfloat16],
                shape="B=1 H=8 T=512 D=64 f32 causal", **main)


def _decode_state(gen, q_dtype, kv_dtype, b=8, h=8, d=64, p=16, maxp=32):
    lengths = [511, 17, 255, 16, 15, 300, 1, 128][:b]
    pool = 1 + b * maxp
    kp = torch.randn((pool, h, p, d), generator=gen, device="cuda")
    vp = torch.randn((pool, h, p, d), generator=gen, device="cuda")
    kp[0] = 1e30                                 # the trash page
    vp[0] = 1e30
    rs = np.random.RandomState(0)
    free = list(rs.permutation(np.arange(1, pool)))
    tables = np.zeros((b, maxp), np.int32)
    for i, ln in enumerate(lengths):
        for j in range(ln // p + 1):
            tables[i, j] = free.pop()
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(q_dtype)
    return (q, kp.to(kv_dtype), vp.to(kv_dtype),
            torch.from_numpy(tables).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def phase_decode(gen) -> dict:
    from bigdl_tpu_torch.ops.decode_attention import (paged_decode,
                                                      paged_decode_plain)

    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for qd, kvd in ((torch.float32, torch.float32),
                    (torch.float32, torch.bfloat16),
                    (torch.bfloat16, torch.bfloat16)):
        q, kp, vp, tables, lengths = _decode_state(gen, qd, kvd)
        out = paged_decode(q, kp, vp, tables, lengths, page_size=16)
        torch.cuda.synchronize()
        ref = paged_decode_plain(q, kp, vp, tables, lengths, page_size=16,
                                 scale=0.125)
        err = (out.float() - ref.float()).abs().max().item()
        tol = F32_TOL if qd == torch.float32 else BF16_TOL
        check(f"paged_decode q {qd} cache {kvd}", err, tol)
        worst[qd] = max(worst[qd], err)
        say(f"phase 3 paged_decode q {str(qd)[6:]} cache {str(kvd)[6:]}: "
            f"max abs err {err:.3e}")
    q, kp, vp, tables, lengths = _decode_state(gen, torch.float32,
                                               torch.float32)
    ms = time_ms(lambda: paged_decode(q, kp, vp, tables, lengths,
                                      page_size=16))
    plain = time_ms(lambda: paged_decode_plain(q, kp, vp, tables, lengths,
                                               page_size=16, scale=0.125))
    b, h, d = q.shape
    positions = int((lengths + 1).sum())
    pages = int((lengths // 16 + 1).sum())
    nbytes = (2 * b * h * d * 4                  # q read, out written
              + 2 * positions * h * d * 4        # live K and V rows
              + pages * 4 + b * 4)               # live table entries, lengths
    flops = 4 * h * d * positions
    b_ms, b_by = bound(nbytes, flops, torch.float32)
    say(f"phase 3 paged_decode time B=8 H=8 Dh=64 P=16 f32: kernel "
        f"{ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(name="paged_decode", route="cuda",
                source="bigdl_tpu_torch/csrc/paged_decode.cu",
                replaces=DECODE_REPLACES, max_abs_err=worst[torch.float32],
                max_abs_err_bf16=worst[torch.bfloat16], ms=ms,
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                shape="B=8 H=8 Dh=64 P=16 f32, lengths up to 511")


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
    for ms, n, key in rows[:8]:
        say(f"phase 5 profile:   {ms / 10:8.4f} ms/step  x{n // 10:<4d} "
            f"{key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import bigdl_tpu_torch  # noqa: F401  (fails where the checkout is missing)

    smi = phase_device()
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    kernels = [phase_flash(gen), phase_decode(gen)]
    model, launches = phase_main_path()
    phase_profile(model)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    say("phase 6 kernels")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
