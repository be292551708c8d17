"""On-card check of the PyTorch/CUDA port: build, hold, serve, train.

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
6. holds the flash-attention kernels K5 (forward), K6 (dq) and K7 (dk/dv)
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
7. builds the 8-block TransformerLM of bench.py:1730 (vocab 4096, embed
   512, 8 heads, FFN 4x, bf16 compute, Adam) on the card from a seed, runs
   ``output`` on one b=4, T=8192 batch (one K5 launch per block) and
   trains it with ``fit`` on period-23 token text (per step one K5, one K6
   and one K7 launch per block), checks that the loss is finite and falls,
   prints a step's time through the pipeline and synchronously
   (alternating turns) and a profile of one step, and holds the card's
   score and gradients against the CPU reference's at reduced width and
   depth on the flash route (T=4096);
8. runs the TransformerLM's fit through the input pipeline
   (``datasets/prefetch.py``) three ways, each one ``fit`` of 3 distinct
   batches cycled to 6 steps: synchronously (``DL4J_TPU_PREFETCH_WORKERS=0``),
   with put-ahead (pinned staging, a side CUDA stream) and with
   ``CacheMode.DEVICE``; fresh nets from one seed must give the same
   losses; times the three in alternating turns; and traces a cached step
   (no H2D copy of a batch) and a put-ahead fit (each batch's copy pinned,
   off the compute stream, and how much of it kernels overlap). The
   char-RNN fits of step 5 run through the pipeline too, timed beside the
   synchronous path in alternating turns;
9. runs an f32-weight 2 x GravesLSTM(512) net at b=32, where K3 has no
   grid, per layer through ``output``, ``rnn_time_step`` and ``fit``
   against the CPU, and an f32 d=256 attention at T=4096, past what the
   flash kernels take in f32, through ``mha``'s dense body against the
   flash plain versions;
10. prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
   "device": ...}`` line.

Any failure raises, and the script exits nonzero without the last line.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time
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
# Each fit's score is its last TBPTT segment's loss, which moves from fit
# to fit by up to a fifth on this data (on an H100: 160.8 at the first
# fit, 110.4 to 148.3 after). The check compares the mean of the last
# three fits with the first: 19.5% lower on the card; it must be at least
# 10% lower.
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
    mm = 2 * B * H * 4 * H  # one [b, H] x [H, 4H] product
    k1_bytes = (T * B * 4 * H * 4 + H * 4 * H * 2 + 3 * H * 4 + 4 * B * H * 4
                + T * B * H * 4)
    for label, m in (("masked", mask), ("unmasked", None)):
        args = (xp, rw1, peep3, m, h0, c0)
        ys, hT, cT = lstm_cell.lstm_fwd(*args)
        torch.cuda.synchronize()
        ref = lstm_cell.lstm_fwd_plain(*args)
        err = max((a - r).abs().max().item() for a, r in zip((ys, hT, cT), ref))
        bitwise = same_bits((ys, hT, cT), lstm_cell.lstm_fwd(*args))
        ms = cuda_ms(lambda: lstm_cell.lstm_fwd(*args), 20)
        plain_ms = cuda_ms(lambda: lstm_cell.lstm_fwd_plain(*args), 3)
        nbytes = k1_bytes + (T * B * 4 if m is not None else 0)
        bms, by = bound(nbytes, T * mm, T * B * H * (CELL_OPS + (6 if m is not None else 0)))
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
    nbytes = (T * B * 4 * H * 4 + 3 * H * 4 * H * 2 + 4 * H * 4 + 6 * H * 4
              + 8 * B * H * 4 + T * B * H * 4)
    bms, by = bound(nbytes, 3 * T * mm, 2 * T * B * H * CELL_OPS)
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
    mm = 2 * b * H * 4 * H          # one [b, H] x [H, 4H] product
    seq, seq4 = t * b * H * 4, t * b * 4 * H * 4   # f32 [T, b, H] and [T, b, 4H]
    w_bytes, st = H * 4 * H * 2, b * H * 4
    for label, m in (("masked", mask), ("unmasked", None)):
        fargs = (xp, rw1, peep3, m, h0, c0)
        got = lstm_cell.lstm_fwd(*fargs, save_reserve=True)
        torch.cuda.synchronize()
        ref = lstm_cell.lstm_fwd_plain(*fargs, save_reserve=True)
        e_f = err(got, ref)
        bitwise_f = same_bits(got, lstm_cell.lstm_fwd(*fargs, save_reserve=True))
        ms = cuda_ms(lambda: lstm_cell.lstm_fwd(*fargs, save_reserve=True), 20)
        plain_ms = cuda_ms(lambda: lstm_cell.lstm_fwd_plain(*fargs, save_reserve=True), 3)
        mbytes = t * b * 4 if m is not None else 0
        bms, by = bound(seq4 + w_bytes + 3 * H * 4 + 4 * st + seq + mbytes + seq4 + seq,
                        t * mm, t * b * H * (CELL_OPS + (6 if m is not None else 0)))
        route = lstm_design("K1", rw1.dtype, b, H, reserve=True)
        results[f"lstm_fwd_train/{label}"] = dict(max_abs_err=e_f, ms=ms, plain_ms=plain_ms,
                                                  bound_ms=bms, bound_by=by, design=route)
        log(f"K1 lstm_fwd train {label} b={b} T={t}: max_abs_err={e_f:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by}; {1e3 * ms / t:.2f} us a step); "
            f"two launches bitwise equal: {bitwise_f}; route: {route}")

        _, _, _, gates, cseq = ref
        bargs = (dy, gates, cseq, rw1, peep3, m, c0, dhT, dcT)
        got = lstm_cell.lstm_bwd(*bargs)
        torch.cuda.synchronize()
        e_b = err(got, lstm_cell.lstm_bwd_plain(*bargs))
        bitwise_b = same_bits(got, lstm_cell.lstm_bwd(*bargs))
        ms = cuda_ms(lambda: lstm_cell.lstm_bwd(*bargs), 20)
        plain_ms = cuda_ms(lambda: lstm_cell.lstm_bwd_plain(*bargs), 3)
        bms, by = bound(seq + seq4 + seq + mbytes + w_bytes + 3 * H * 4 + 5 * st + seq4
                        + 3 * H * 4, t * mm, t * b * H * (CELL_BWD_OPS + 4))
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
    bms, by = bound(seq4 + 3 * w_bytes + 4 * H * 4 + 6 * H * 4 + 8 * st + seq
                    + 3 * seq + 2 * seq4, 3 * t * mm, 2 * t * b * H * CELL_OPS)
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
    bms, by = bound(seq + 2 * seq4 + 2 * seq + 3 * w_bytes + 6 * H * 4 + 10 * st
                    + 2 * seq4 + 6 * H * 4, 3 * t * mm, 2 * t * b * H * CELL_BWD_OPS)
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
    peepholes so that the peephole terms are exercised (init draws 0)."""
    from deeplearning4j_torch import MultiLayerNetwork

    net = MultiLayerNetwork(conf).init()          # device defaults to the card
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for impl in list(net.impls)[:2]:
            for k in ("pi", "pf", "po"):
                getattr(impl, k).copy_((torch.randn(H, generator=g) * 0.1).to(net.device))
    return net


def one_hot(rng, b, t):
    return np.eye(VOCAB, dtype=np.float32)[rng.integers(0, VOCAB, (b, t))]


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
    srv.register("charrnn", net, time_buckets=TIME_BUCKETS, linger_ms=10.0,
                 input_shape=(T, VOCAB), warmup=True)
    srv.register("charrnn_fixed", net, linger_ms=10.0, input_shape=(T, VOCAB),
                 warmup=True)
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


def profile_call(label, fn):
    """One call of ``fn`` under torch.profiler: device time by kernel, and
    the card's busy share of the call's wall time (profiler on, so slightly
    slower than an unprofiled call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not spans:
        log(f"profile of {label}: the profiler recorded no device events")
        return None
    spans.sort()
    busy, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    log(f"profile of {label}: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), device time by kernel:")
    for name, us in top:
        log(f"  {us / 1e3:9.3f} ms  {name[:100]}")
    return {"wall_ms": wall_us / 1e3, "busy_ms": busy / 1e3,
            "top_ms": {name[:100]: us / 1e3 for name, us in top}}


def train(conf):
    """The training main path at full width: fit on a b=64, T=200 batch,
    unmasked (the fused pair: one K3-with-reserve and one K4 launch per
    TBPTT segment) and masked with variable lengths (per layer: two K1-
    with-reserve and two K2 launches per segment). Counts are reset just
    before and read just after; each fit's own launches are checked too."""
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
    losses = {}
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
    launches = read_counts()
    log(f"training main path: {TRAIN_FITS} unmasked + {MASKED_FITS} masked fits of b={TRAIN_B} "
        f"T={TRAIN_SEQ} ({segs} TBPTT segments each), launches {launches}")
    for label, ls in losses.items():
        log(f"{label} loss per fit: " + " ".join(f"{x:.3f}" for x in ls))
        if not np.isfinite(ls).all():
            raise AssertionError(f"{label} training loss is not finite: {ls}")
    first, last3 = losses["unmasked"][0], float(np.mean(losses["unmasked"][-3:]))
    drop = 1.0 - last3 / first
    log(f"unmasked loss: mean of the last three fits {last3:.3f}, {100 * drop:.1f}% below "
        f"the first fit's {first:.3f}")
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
    return {"launches": launches, "losses": losses, "fit_ms": times, "pipeline": pipe,
            "profile": prof, "profile_masked": prof_m}


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


def lm_conf(vocab=LM_VOCAB, embed=LM_E, heads=LM_HEADS, blocks=LM_BLOCKS):
    """The TransformerLM of bench.py:1730 (or a cut of it), bf16 compute."""
    from deeplearning4j_torch.models import TransformerLM

    conf = TransformerLM(vocab_size=vocab, embed_dim=embed, num_heads=heads,
                         num_blocks=blocks, seed=1).conf()
    conf.global_conf.compute_dtype = "bfloat16"
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
            "losses": losses, "step_ms": step_ms, "profile": prof}


def check_lm_reference():
    """compute_gradient_and_score of a cut TransformerLM on the card against
    the same network on the CPU, both on the flash route (T=4096): the card
    through K5-K7, the CPU through their plain versions."""
    from deeplearning4j_torch import DataSet
    from deeplearning4j_torch.nn.graph import ComputationGraph

    conf = lm_conf(vocab=256, embed=128, heads=2, blocks=2)
    net = ComputationGraph(conf).init()
    cpu = ComputationGraph(lm_conf(vocab=256, embed=128, heads=2, blocks=2)).init(
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
    log(f"card vs CPU reference, TransformerLM E=128 2 blocks T=4096: score {s_card:.3f} vs "
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


def trace_call(label, fn):
    """One call of ``fn`` under torch.profiler, its Chrome trace written to
    ``build/traces/`` and read back: the device events with their streams,
    the compute stream (the one with the most kernel time), each H2D copy
    (stream, bytes, pinned or pageable) and the share of its duration that
    kernels on other streams overlap. None when the profiler recorded no
    device events."""
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
    return trace_summary(label, json.loads(path.read_text())["traceEvents"], wall_ms)


def trace_summary(label, events, wall_ms):
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
    first_kernel = min(e["ts"] for e in dev
                       if e["cat"] == "kernel" and e.get("args", {}).get("stream") == compute)
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
                       "after_first_kernel": lo > first_kernel})
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
            "copies": copies, "batch_copies": big, "memcpy_calls": calls,
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
    with prefetch_workers(2):
        ahead = trace_call("a put-ahead TransformerLM fit of 3 batches",
                           lambda: nets["put_ahead"].fit(ListDataSetIterator(batches)))
    if ahead is not None:
        # the profiler records only some of the worker threads' copies (in
        # one run 3 of the 6 cudaMemcpyAsync calls it logged on the two
        # workers had a device record, the first two missing): every one
        # it records must be pinned and off the compute stream, and those
        # made once the steps had begun mostly overlapped by their kernels
        got = ahead["batch_copies"]
        bad = [c for c in got if c["stream"] == ahead["compute_stream"]
               or "Pinned" not in c["name"]
               or (c["after_first_kernel"] and c["overlap"] < 0.5)]
        if not got or bad:
            raise AssertionError(f"the put-ahead copies are not pinned, off the compute "
                                 f"stream {ahead['compute_stream']} and overlapped: {got}")
        log(f"  the profiler recorded {len(got)} of the {LM_PIPE_BATCHES} labels copies, "
            f"{sum(c['after_first_kernel'] for c in got)} of them made under the steps")
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


def build():
    """Compile every kernel of the port, one nvcc per source, all at once,
    and print what ptxas reports of registers, shared memory and spills."""
    from deeplearning4j_torch.ops import cuda_build, flash_attention, lstm_cell, lstm_fused

    t0 = time.perf_counter()
    logs = cuda_build.build_all([lstm_cell.SOURCE, lstm_cell.BWD_SOURCE, lstm_fused.SOURCE,
                                 lstm_fused.BWD_SOURCE, flash_attention.FWD_SOURCE,
                                 flash_attention.DQ_SOURCE, flash_attention.DKV_SOURCE])
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
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


def kernel_line(serving, training, served, streamed, trained, flash, lm):
    """The {"kernels": [...]} entries: for K1-K4 numbers at the char-RNN's
    training shape, the launches of its training main path, and K1/K3's
    serving numbers; for K5-K7 numbers at the TransformerLM's shape and
    the launches of its training main path (its ``output`` apart)."""
    shape = {"b": TRAIN_B, "T": TRAIN_T, "H": H, "w": "bf16", "peepholes": True}
    sshape = {"b": B, "T": T, "H": H, "w": "bf16", "peepholes": True}

    def entry(name, counter, source, replaces, res, extra=None):
        e = {"name": name, "route": "cuda", "source": f"deeplearning4j_torch/csrc/{source}",
             "replaces": replaces, "launches": trained[counter],
             "max_abs_err": max(r["max_abs_err"] for r in res), "ms": res[0]["ms"],
             "plain_ms": res[0]["plain_ms"], "bound_ms": res[0]["bound_ms"],
             "bound_by": res[0]["bound_by"], "library_ms": None, "shape": shape}
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
              [training["lstm_fwd_train/masked"], training["lstm_fwd_train/unmasked"]],
              {**serving_of("lstm_fwd", ["lstm_fwd/masked", "lstm_fwd/unmasked"]),
               "design": training["lstm_fwd_train/masked"]["design"]}),
        entry("lstm_bwd", "lstm_bwd", "lstm_cell_bwd.cu", "deeplearning4j_tpu/ops/lstm_cell.py:235",
              [training["lstm_bwd/masked"], training["lstm_bwd/unmasked"]],
              {"design": training["lstm_bwd/masked"]["design"]}),
        entry("lstm2_fwd", "lstm2_fwd_train", "lstm_fused.cu", "deeplearning4j_tpu/ops/lstm_fused.py:111",
              [training["lstm2_fwd_train"]],
              {**serving_of("lstm2_fwd", ["lstm2_fwd"]),
               "design": training["lstm2_fwd_train"]["design"]}),
        entry("lstm2_bwd", "lstm2_bwd", "lstm_fused_bwd.cu", "deeplearning4j_tpu/ops/lstm_fused.py:249",
              [training["lstm2_bwd"]], {"design": training["lstm2_bwd"]["design"]}),
        *(flash_entry(name, src, line, flash[name], lm) for name, src, line in (
            ("flash_fwd", "flash_attn_fwd.cu", 202), ("flash_dq", "flash_attn_dq.cu", 311),
            ("flash_dkv", "flash_attn_dkv.cu", 361))),
    ]


def flash_entry(name, source, line, res, lm):
    e = {"name": name, "route": "cuda", "source": f"deeplearning4j_torch/csrc/{source}",
         "replaces": f"deeplearning4j_tpu/ops/flash_attention.py:{line}",
         "launches": lm["launches"][name], "launches_per_step": lm["launches"][name] // LM_STEPS,
         **res,
         "shape": {"b": LM_B, "h": LM_HEADS, "T": LM_T, "d": LM_D, "dtype": "bf16",
                   "causal": True},
         "output_launches": lm["output_launches"][name]}
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

    build()
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
    del net
    torch.cuda.empty_cache()
    check_flash_small()
    flash = check_flash_kernels()
    torch.cuda.empty_cache()
    lm = transformer_lm()
    check_lm_reference()
    lm_pipeline()
    torch.cuda.empty_cache()
    check_lstm_pair_f32()
    check_flash_f32_wide()

    print(json.dumps({"kernels": kernel_line(serving, training, served, streamed,
                                             trained["launches"], flash, lm)}))
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
