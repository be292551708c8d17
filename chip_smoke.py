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
   backward fed the same dy, reserve and state as its plain version);
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
   falls, prints a fit's time and a profile of one fit, and holds the
   card's gradients against the CPU reference's (unmasked and masked);
6. prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
   "device": ...}`` line.

Any failure raises, and the script exits nonzero without the last line.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

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
        ms = cuda_ms(lambda: lstm_cell.lstm_fwd(*args), 20)
        plain_ms = cuda_ms(lambda: lstm_cell.lstm_fwd_plain(*args), 3)
        nbytes = k1_bytes + (T * B * 4 if m is not None else 0)
        bms, by = bound(nbytes, T * mm, T * B * H * (CELL_OPS + (6 if m is not None else 0)))
        results[f"lstm_fwd/{label}"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                            bound_ms=bms, bound_by=by)
        log(f"K1 lstm_fwd {label}: max_abs_err={err:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by}; chain of {T} "
            f"dependent steps)")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"K1 {label} disagrees with its plain version: "
                                 f"{err} > {KERNEL_ATOL}")

    args = (xp, rw1, w2, rw2, b2, peep6, h0pack)
    ys2, hc = lstm_fused.lstm2_fwd(*args)
    torch.cuda.synchronize()
    ref = lstm_fused.lstm2_fwd_plain(*args)
    err = max((ys2 - ref[0]).abs().max().item(), (hc - ref[1]).abs().max().item())
    ms = cuda_ms(lambda: lstm_fused.lstm2_fwd(*args), 20)
    plain_ms = cuda_ms(lambda: lstm_fused.lstm2_fwd_plain(*args), 3)
    nbytes = (T * B * 4 * H * 4 + 3 * H * 4 * H * 2 + 4 * H * 4 + 6 * H * 4
              + 8 * B * H * 4 + T * B * H * 4)
    bms, by = bound(nbytes, 3 * T * mm, 2 * T * B * H * CELL_OPS)
    results["lstm2_fwd"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by)
    log(f"K3 lstm2_fwd: max_abs_err={err:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"bound_ms={bms:.5f} ({by}; chain of {T + 1} dependent phases)")
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
        ms = cuda_ms(lambda: lstm_cell.lstm_fwd(*fargs, save_reserve=True), 20)
        plain_ms = cuda_ms(lambda: lstm_cell.lstm_fwd_plain(*fargs, save_reserve=True), 3)
        mbytes = t * b * 4 if m is not None else 0
        bms, by = bound(seq4 + w_bytes + 3 * H * 4 + 4 * st + seq + mbytes + seq4 + seq,
                        t * mm, t * b * H * (CELL_OPS + (6 if m is not None else 0)))
        results[f"lstm_fwd_train/{label}"] = dict(max_abs_err=e_f, ms=ms, plain_ms=plain_ms,
                                                  bound_ms=bms, bound_by=by)
        log(f"K1 lstm_fwd train {label} b={b} T={t}: max_abs_err={e_f:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by})")

        _, _, _, gates, cseq = ref
        bargs = (dy, gates, cseq, rw1, peep3, m, c0, dhT, dcT)
        got = lstm_cell.lstm_bwd(*bargs)
        torch.cuda.synchronize()
        e_b = err(got, lstm_cell.lstm_bwd_plain(*bargs))
        ms = cuda_ms(lambda: lstm_cell.lstm_bwd(*bargs), 20)
        plain_ms = cuda_ms(lambda: lstm_cell.lstm_bwd_plain(*bargs), 3)
        bms, by = bound(seq + seq4 + seq + mbytes + w_bytes + 3 * H * 4 + 5 * st + seq4
                        + 3 * H * 4, t * mm, t * b * H * (CELL_BWD_OPS + 4))
        results[f"lstm_bwd/{label}"] = dict(max_abs_err=e_b, ms=ms, plain_ms=plain_ms,
                                            bound_ms=bms, bound_by=by)
        log(f"K2 lstm_bwd {label} b={b} T={t}: max_abs_err={e_b:.3e} kernel_ms={ms:.4f} "
            f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by})")
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
    ms = cuda_ms(lambda: lstm_fused.lstm2_fwd(*fargs, save_reserve=True), 20)
    plain_ms = cuda_ms(lambda: lstm_fused.lstm2_fwd_plain(*fargs, save_reserve=True), 3)
    bms, by = bound(seq4 + 3 * w_bytes + 4 * H * 4 + 6 * H * 4 + 8 * st + seq
                    + 3 * seq + 2 * seq4, 3 * t * mm, 2 * t * b * H * CELL_OPS)
    results["lstm2_fwd_train"] = dict(max_abs_err=e_f, ms=ms, plain_ms=plain_ms,
                                      bound_ms=bms, bound_by=by)
    log(f"K3 lstm2_fwd train b={b} T={t}: max_abs_err={e_f:.3e} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by})")

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
    results["lstm2_bwd"] = dict(max_abs_err=e_b, ms=ms, plain_ms=plain_ms,
                                bound_ms=bms, bound_by=by)
    log(f"K4 lstm2_bwd b={b} T={t}: max_abs_err={e_b:.3e} kernel_ms={ms:.4f} "
        f"plain_ms={plain_ms:.3f} bound_ms={bms:.5f} ({by})")
    if not e_f <= KERNEL_ATOL:
        raise AssertionError(f"K3 with reserve disagrees with its plain version: "
                             f"{e_f} > {KERNEL_ATOL}")
    if not e_b <= BWD_ATOL:
        raise AssertionError(f"K4 disagrees with its plain version: {e_b} > {BWD_ATOL}")
    return results


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
    from deeplearning4j_torch.ops import lstm_cell, lstm_fused

    return {c.name: c for c in (lstm_cell.COUNTER, lstm_cell.TRAIN_COUNTER,
                                lstm_cell.BWD_COUNTER, lstm_fused.COUNTER,
                                lstm_fused.TRAIN_COUNTER, lstm_fused.BWD_COUNTER)}


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


def profile_fit(net, ds):
    """One fit under torch.profiler: device time by kernel, and the card's
    busy share of the fit's wall time (profiler on, so slightly slower
    than an unprofiled fit)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        net.fit(ds)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    if not spans:
        log("profile of one fit: the profiler recorded no device events")
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
    log(f"profile of one unmasked fit: wall {wall_us / 1e3:.3f} ms, device busy "
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

    times = {}
    for label, data in (("unmasked", ds), ("masked", mds)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TIMED_FITS):
            net.fit(data)
        net.score()                                   # the value: a sync
        times[label] = (time.perf_counter() - t0) * 1e3 / TIMED_FITS
        log(f"smoke number, not a benchmark: a {label} fit {times[label]:.3f} ms (mean of "
            f"{TIMED_FITS}), {TRAIN_B * TRAIN_SEQ / times[label] * 1e3:.0f} characters/s")
    return {"launches": launches, "losses": losses, "fit_ms": times,
            "profile": profile_fit(net, ds)}


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


def build():
    """Compile every kernel of the port, one nvcc per source, all at once,
    and print what ptxas reports of registers, shared memory and spills."""
    from deeplearning4j_torch.ops import cuda_build, lstm_cell, lstm_fused

    t0 = time.perf_counter()
    logs = cuda_build.build_all([lstm_cell.SOURCE, lstm_cell.BWD_SOURCE, lstm_fused.SOURCE,
                                 lstm_fused.BWD_SOURCE])
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")


def kernel_line(serving, training, served, streamed, trained):
    """The {"kernels": [...]} entries: numbers at the training shape, the
    launches of the training main path, and K1/K3's serving numbers."""
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
        return {"serving": {"launches": served[name], "stream_launches": streamed[name],
                            "max_abs_err": max(x["max_abs_err"] for x in r), "ms": r[0]["ms"],
                            "plain_ms": r[0]["plain_ms"], "bound_ms": r[0]["bound_ms"],
                            "bound_by": r[0]["bound_by"],
                            "cudnn_yardstick_ms": serving[name + "/cudnn"], "shape": sshape}}

    return [
        entry("lstm_fwd", "lstm_fwd_train", "lstm_cell.cu", "deeplearning4j_tpu/ops/lstm_cell.py:99",
              [training["lstm_fwd_train/masked"], training["lstm_fwd_train/unmasked"]],
              serving_of("lstm_fwd", ["lstm_fwd/masked", "lstm_fwd/unmasked"])),
        entry("lstm_bwd", "lstm_bwd", "lstm_cell_bwd.cu", "deeplearning4j_tpu/ops/lstm_cell.py:235",
              [training["lstm_bwd/masked"], training["lstm_bwd/unmasked"]]),
        entry("lstm2_fwd", "lstm2_fwd_train", "lstm_fused.cu", "deeplearning4j_tpu/ops/lstm_fused.py:111",
              [training["lstm2_fwd_train"]], serving_of("lstm2_fwd", ["lstm2_fwd"])),
        entry("lstm2_bwd", "lstm2_bwd", "lstm_fused_bwd.cu", "deeplearning4j_tpu/ops/lstm_fused.py:249",
              [training["lstm2_bwd"]]),
    ]


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
    conf = char_rnn_conf()
    net = build_net(conf)
    served, streamed = serve(net)
    check_reference(conf, net)
    trained = train(conf)
    check_train_reference(conf)

    print(json.dumps({"kernels": kernel_line(serving, training, served, streamed,
                                             trained["launches"])}))
    log(f"chip_smoke took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
