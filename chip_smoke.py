"""On-card check of the PyTorch/CUDA port: build, hold, serve.

    python3 chip_smoke.py

Needs one CUDA card (an H100 for the numbers to mean what PERF.md says)
and the CUDA toolkit; run from the root of the repository. It

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the hand-written kernels from ``deeplearning4j_torch/csrc``
   (one ``nvcc`` per source, started together);
3. holds each kernel against its plain PyTorch version on the card at
   serving shapes (b=32, T=200, H=512, bf16 recurrent weights, peepholes;
   K1 with a fractional mask and without one, K3 without), timing both and
   printing the card's least possible time for the same work;
4. builds the full-width char-RNN (vocab 80, 2 x GravesLSTM(512),
   RnnOutputLayer softmax, bf16 compute) on the card from a seed, serves it
   over HTTP twice — ``charrnn`` with time buckets (masked requests, K1) and
   ``charrnn_fixed`` at T=200 (unmasked requests, K3) — sends concurrent
   requests to both and some ``rnn_time_step`` calls, and checks every
   answer against ``model.output`` and the CPU reference;
5. prints a ``{"kernels": [...]}`` line and, last, the ``{"ok": true,
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

B, T, H, VOCAB = 32, 200, 512, 80
TIME_BUCKETS = (64, 128, 200)
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


def build_net():
    from deeplearning4j_torch import NeuralNetConfiguration, MultiLayerNetwork
    from deeplearning4j_torch.nn.conf.layers import GravesLSTM, RnnOutputLayer

    conf = (NeuralNetConfiguration.builder().seed(1).activation("tanh")
            .compute_dtype("bfloat16").list()
            .layer(GravesLSTM(n_in=VOCAB, n_out=H))
            .layer(GravesLSTM(n_in=H, n_out=H))
            .layer(RnnOutputLayer(n_in=H, n_out=VOCAB, activation="softmax",
                                  loss="mcxent"))
            .build())
    net = MultiLayerNetwork(conf).init()          # device defaults to the card
    # random peepholes, so the peephole terms are exercised (init draws 0)
    g = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for impl in list(net.impls)[:2]:
            for k in ("pi", "pf", "po"):
                getattr(impl, k).copy_((torch.randn(H, generator=g) * 0.1).to(net.device))
    return conf, net


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
    from deeplearning4j_torch.ops import lstm_cell, lstm_fused

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
    def counts():
        return {"lstm_fwd": lstm_cell.COUNTER.launches,
                "lstm2_fwd": lstm_fused.COUNTER.launches}

    def reset():
        lstm_cell.COUNTER.reset()
        lstm_fused.COUNTER.reset()

    port = srv.start(port=0)
    try:
        reset()
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=16) as pool:
            futs = ([pool.submit(post, port, "charrnn", x) for x in masked]
                    + [pool.submit(post, port, "charrnn_fixed", x) for x in fixed])
            answers = [f.result() for f in futs]
        serve_s = time.perf_counter() - t0
        launches = counts()
    finally:
        srv.stop()
    log(f"served {len(answers)} HTTP requests in {serve_s:.3f} s; main-path launches "
        f"{launches}")
    if launches["lstm_fwd"] < 1 or launches["lstm2_fwd"] < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # streaming, counted on its own: unmasked chunks through the fused pair
    net.rnn_clear_previous_state()
    reset()
    steps = [net.rnn_time_step(stream[:, a:b]) for a, b in ((0, 40), (40, 41), (41, 120))]
    torch.cuda.synchronize()
    stream_launches = counts()
    log(f"rnn_time_step launches {stream_launches}")
    if stream_launches["lstm2_fwd"] != len(steps):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from deeplearning4j_torch.ops import cuda_build, lstm_cell, lstm_fused

    t0 = time.perf_counter()
    logs = cuda_build.build_all([lstm_cell.SOURCE, lstm_fused.SOURCE])
    log(f"built kernels in {time.perf_counter() - t0:.1f} s")
    for src, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    results = check_kernels()
    conf, net = build_net()
    launches, stream_launches = serve(net)
    check_reference(conf, net)

    k1m, k1u, k3 = results["lstm_fwd/masked"], results["lstm_fwd/unmasked"], results["lstm2_fwd"]
    kernels = [
        {"name": "lstm_fwd", "route": "cuda", "source": "deeplearning4j_torch/csrc/lstm_cell.cu",
         "replaces": "deeplearning4j_tpu/ops/lstm_cell.py:99", "launches": launches["lstm_fwd"],
         "max_abs_err": max(k1m["max_abs_err"], k1u["max_abs_err"]),
         "ms": k1m["ms"], "plain_ms": k1m["plain_ms"], "bound_ms": k1m["bound_ms"],
         "bound_by": k1m["bound_by"], "library_ms": None,
         "stream_launches": stream_launches["lstm_fwd"],
         "ms_unmasked": k1u["ms"], "plain_ms_unmasked": k1u["plain_ms"],
         "cudnn_yardstick_ms": results["lstm_fwd/cudnn"],
         "shape": {"b": B, "T": T, "H": H, "rw": "bf16", "peepholes": True}},
        {"name": "lstm2_fwd", "route": "cuda", "source": "deeplearning4j_torch/csrc/lstm_fused.cu",
         "replaces": "deeplearning4j_tpu/ops/lstm_fused.py:111",
         "launches": launches["lstm2_fwd"], "max_abs_err": k3["max_abs_err"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
         "bound_by": k3["bound_by"], "library_ms": None,
         "stream_launches": stream_launches["lstm2_fwd"],
         "cudnn_yardstick_ms": results["lstm2_fwd/cudnn"],
         "shape": {"b": B, "T": T, "H": H, "rw": "bf16", "peepholes": True}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
