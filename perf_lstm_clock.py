"""Where a step of K1, K2 and K3 goes on the card: clock64() stamps.

    python3 perf_lstm_clock.py [CHECKOUT ...]

For this checkout, or each one named, copies its ``deeplearning4j_torch``
package into ``build/clock/<n>/`` and inserts ``clock64()`` stamps into
that copy of ``csrc/lstm_cell.cu`` (K1), ``csrc/lstm_cell_bwd.cu`` (K2)
and ``csrc/lstm_fused.cu`` (K3) at fixed points of the body that bf16
weights take at the main path's shapes (the tensor-core body where the
source has one, else the CUDA-core body), read by thread 0 of one block
(block 0 unless an export sets another), plus an export that copies the
stamps out. In a fresh process from each copy it runs K1 serving (b=32,
T=200, masked), K1 with the reserve and K2 (b=64, T=50, masked), K3
serving (b=32, T=200) and K3 with the reserve (b=64, T=50), H=512, bf16
weights, peepholes, and prints for each kernel its time (CUDA events,
mean of 10 launches), the stamps' cycles per microsecond, and the mean
cycles of each stretch between two consecutive stamps (a step, or a
phase of K3's wavefront), with its count. Thread 0 runs a product warp's
lane and a cell. Where K3's tensor-core body runs layer 2 on blocks of
their own, the first of them is stamped in a second run (``block N`` in
the label). A block's barrier wait includes the wait for the slowest
other block. The stamps cost a little time themselves; compare
stretches, not the kernel's time, with an unstamped run. Needs one CUDA
card.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
STAMPS = 1024  # per stamp id

HEADER = f"""
__device__ long long dl4j_clk[8][{STAMPS}];
__device__ int dl4j_clk_block = 0;
#define DL4J_CLK(id) \\
  if (blockIdx.x == dl4j_clk_block && threadIdx.x == 0 && clk_n[id] < {STAMPS}) \\
    dl4j_clk[id][clk_n[id]++] = clock64()
"""
EXPORT = """
// copies the stamps out and clears them
extern "C" int dl4j_clock_read(void* dst) {
  static long long zeros[8][%d];
  cudaError_t err = cudaMemcpyFromSymbol(dst, dl4j::dl4j_clk, sizeof(dl4j::dl4j_clk));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(dl4j::dl4j_clk, zeros, sizeof(zeros));
}

// the block whose thread 0 stamps
extern "C" int dl4j_clock_block(int block) {
  return (int)cudaMemcpyToSymbol(dl4j::dl4j_clk_block, &block, sizeof(int));
}
""" % STAMPS
START = "  cg::grid_group grid = cg::this_grid();\n"

# (anchor, text put before it, text put after it) for each body; every
# anchor must occur exactly once. Stamp ids name the point they mark.
BODIES = {
    "K1 tensor cores": ("lstm_cell.cu", "lstm_fwd_tc_kernel", {
        0: "step end", 1: "barrier passed", 2: "tiles written", 3: "cell done"}, [
        ("    grid.sync();  // h_{t-1} is in slot", "    DL4J_CLK(0);\n", ""),
        ("    if (mma_warp)\n      rows_product<kFwdCols", "    DL4J_CLK(1);\n", ""),
        ("    __syncthreads();     // the partial tiles are written\n", "",
         "    DL4J_CLK(2);\n"),
        ("    prefetch(t + 1);  // lands during", "    DL4J_CLK(3);\n", "")]),
    "K1 CUDA cores": ("lstm_cell.cu", "lstm_fwd_kernel", {
        0: "barrier passed", 1: "h loaded", 2: "products done", 3: "step end"}, [
        ("    load_h(h_s, hprev, B * H);\n    __syncthreads();\n", "    DL4J_CLK(0);\n",
         "    DL4J_CLK(1);\n"),
        ("    float* yst = ys + (size_t)t * B * H;\n", "    DL4J_CLK(2);\n", ""),
        ("    grid.sync();  // h_t is complete in ys[t]", "    DL4J_CLK(3);\n", "")]),
    "K2 tensor cores": ("lstm_cell_bwd.cu", "lstm_bwd_tc_kernel", {
        0: "step end", 1: "barrier passed", 5: "products done", 2: "partial sums done",
        3: "reserve landed", 4: "cell done"}, [
        ("      grid.sync();  // dz_{t+1} is published", "      DL4J_CLK(0);\n",
         ""),
        ("      dh = product((t + 1) & 1) + resid;\n", "      DL4J_CLK(1);\n",
         "      DL4J_CLK(2);\n"),
        ("    __syncthreads();  // the partial tiles are written\n", "    DL4J_CLK(5);\n", ""),
        ("    cp_async_wait<0>();  // this thread's reserve for step t\n", "",
         "    DL4J_CLK(3);\n"),
        ("    prefetch(t - 1);  // lands during", "    DL4J_CLK(4);\n", "")]),
    "K2 CUDA cores": ("lstm_cell_bwd.cu", "lstm_bwd_kernel", {
        0: "products done", 1: "cell done", 2: "barrier passed"}, [
        ("    __syncthreads();  // dh_s of the previous product (or dhT) is complete\n", "",
         "    DL4J_CLK(0);\n"),
        ("    grid.sync();  // dz_t of every unit is in xs", "    DL4J_CLK(1);\n", ""),
        ("    // dh_{t-1} = bf16(dz_t) . RW^T for the block's units", "    DL4J_CLK(2);\n", "")]),
    "K3 tensor cores": ("lstm_fused.cu", "lstm2_fwd_tc_kernel", {
        0: "phase end", 1: "barrier passed", 2: "tiles written", 3: "cells done"}, [
        ("    // h1_{p-1} is in slot (p+1)&1 of x1", "    DL4J_CLK(0);\n", ""),
        ("    const bool on = layer == 1 ? p < T : p >= 1;", "    DL4J_CLK(1);\n", ""),
        ("    __syncthreads();     // the partial tiles are written\n", "",
         "    DL4J_CLK(2);\n"),
        ("    prefetch(p + 1);  // lands during", "    DL4J_CLK(3);\n", "")]),
    "K3 CUDA cores": ("lstm_fused.cu", "lstm2_fwd_kernel", {
        0: "barrier passed", 1: "h loaded", 2: "products done", 3: "phase end"}, [
        ("    const bool l1 = p < T, l2 = p >= 1;", "    DL4J_CLK(0);\n", ""),
        ("    if (l2) load_h(h2_s, h2prev, (int)BH);\n    __syncthreads();\n", "",
         "    DL4J_CLK(1);\n"),
        ("    for (int e = threadIdx.x; e < B * HB; e += blockDim.x) {\n"
         "      const int r = e / HB, u = e % HB, hu = u0 + u;\n", "    DL4J_CLK(2);\n", ""),
        ("    grid.sync();  // h1_p and h2_{p-1} are published", "    DL4J_CLK(3);\n", "")]),
}
SOURCES = {"K1": "lstm_cell.cu", "K2": "lstm_cell_bwd.cu", "K3": "lstm_fused.cu"}
TC_KERNELS = {"K1": "lstm_fwd_tc_kernel", "K2": "lstm_bwd_tc_kernel", "K3": "lstm2_fwd_tc_kernel"}

PROBE = r"""
import ctypes, json, numpy as np, torch
from deeplearning4j_torch.ops import cuda_build, lstm_cell, lstm_fused
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda")
g = torch.Generator().manual_seed(0)
H = 512
def rnd(*s, scale=1.0):
    return (torch.randn(s, generator=g) * scale).to(dev)
def mask_of(t, b):
    lengths = torch.randint(t // 4, t + 1, (b,), generator=g)
    steps = torch.arange(t)[:, None].float()
    return torch.clamp((lengths[None, :].float() - steps) / 3.0, 0.0, 1.0).to(dev)
rw = rnd(H, 4 * H, scale=H ** -0.5).to(torch.bfloat16)
peep = rnd(3, H, scale=0.1)
out = {}
def stamps(source, fn, block=0):
    lib = cuda_build.library(source, "dl4j_clock_read", [ctypes.c_void_p])
    cuda_build.library(source, "dl4j_clock_block", [ctypes.c_int])
    assert lib.dl4j_clock_block(block) == 0
    buf = np.zeros((8, %(stamps)d), np.int64)
    for _ in range(2):  # the first read clears an earlier launch's stamps
        fn(); torch.cuda.synchronize()
        code = lib.dl4j_clock_read(buf.ctypes.data)
        assert code == 0, code
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(10):
        fn()
    e.record(); torch.cuda.synchronize()
    return buf, s.elapsed_time(e) / 10
for label, b, t, reserve in (("K1 serving b=32 T=200 masked", 32, 200, False),
                             ("K1 with reserve b=64 T=50 masked", 64, 50, True)):
    args = (rnd(t, b, 4 * H), rw, peep, mask_of(t, b), rnd(b, H, scale=0.5), rnd(b, H, scale=0.5))
    buf, ms = stamps(lstm_cell.SOURCE, lambda: lstm_cell.lstm_fwd(*args, save_reserve=reserve))
    out[label] = (buf.tolist(), ms)
b, t = 64, 50
fargs = (rnd(t, b, 4 * H), rw, peep, mask_of(t, b), rnd(b, H, scale=0.5), rnd(b, H, scale=0.5))
_, _, _, gates, cseq = lstm_cell.lstm_fwd_plain(*fargs, save_reserve=True)
bargs = (rnd(t, b, H, scale=0.1), gates, cseq, rw, peep, fargs[3], fargs[5],
         rnd(b, H, scale=0.1), rnd(b, H, scale=0.1))
buf, ms = stamps(lstm_cell.BWD_SOURCE, lambda: lstm_cell.lstm_bwd(*bargs))
out["K2 b=64 T=50 masked"] = (buf.tolist(), ms)
w2, rw2 = (rnd(H, 4 * H, scale=H ** -0.5).to(torch.bfloat16) for _ in range(2))
b2, peep6 = rnd(4 * H, scale=0.1), rnd(6, H, scale=0.1)
for label, b, t, reserve in (("K3 serving b=32 T=200", 32, 200, False),
                             ("K3 with reserve b=64 T=50", 64, 50, True)):
    args = (rnd(t, b, 4 * H), rw, w2, rw2, b2, peep6, rnd(4, b, H, scale=0.5))
    # the tensor-core body runs layer 2 on blocks [H / units, 2 H / units):
    # stamp its first block too
    tc, units = (lstm_fused.fwd_route(rw.dtype, b, H, reserve)
                 if hasattr(lstm_fused, "fwd_route") else (False, 0))
    for block in (0, H // units) if tc else (0,):
        buf, ms = stamps(lstm_fused.SOURCE,
                         lambda: lstm_fused.lstm2_fwd(*args, save_reserve=reserve), block)
        out[f"{label}, block {block}"] = (buf.tolist(), ms)
print("RESULT " + json.dumps(out))
""" % {"stamps": STAMPS}


def instrument(src: str, kernel: str, anchors) -> str:
    """The source with the stamps, their counters in every kernel, and the
    export."""
    head, body = src.split("namespace dl4j {", 1)
    body = body.replace(START, START + "  int clk_n[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n")
    for anchor, before, after in anchors:
        if body.count(anchor) != 1:
            raise SystemExit(f"{kernel}: anchor {anchor!r} found {body.count(anchor)} times")
        body = body.replace(anchor, before + anchor + after)
    return head + "namespace dl4j {\n" + HEADER + body + EXPORT


def body_of(kernel: str, text: str) -> str:
    """The name in BODIES of the body that bf16 weights take in kernel K1,
    K2 or K3, whose source is ``text``."""
    return kernel + (" tensor cores" if TC_KERNELS[kernel] in text else " CUDA cores")


def report(name: str, kernels: dict, labels: dict) -> None:
    for label, (buf, ms) in kernels.items():
        body = labels[label.split()[0]]
        names = BODIES[body][2]
        marks = sorted((v, i) for i, row in enumerate(buf) for v in row if v)
        stretch = {}
        for (t0, a), (t1, b) in zip(marks, marks[1:]):
            key = f"{names.get(a, a)} -> {names.get(b, b)}"
            n, total = stretch.get(key, (0, 0))
            stretch[key] = (n + 1, total + t1 - t0)
        cycles = marks[-1][0] - marks[0][0] if marks else 0
        print(f"{name}: {label} ({body}): {ms:.4f} ms a launch; stamped span {cycles} cycles, "
              f"{cycles / (ms * 1e3):.0f} cycles a microsecond if the span is the launch")
        for key, (n, total) in sorted(stretch.items(), key=lambda kv: -kv[1][1]):
            print(f"  {key}: {total / n:9.0f} cycles mean over {n}")


def main(argv) -> int:
    roots = [Path(a).resolve() for a in argv] or [HERE]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi, flush=True)
    for n, root in enumerate(roots):
        work = HERE / "build" / "clock" / str(n)
        shutil.rmtree(work, ignore_errors=True)
        shutil.copytree(root / "deeplearning4j_torch", work / "deeplearning4j_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        labels = {}
        for name, source in SOURCES.items():
            path = work / "deeplearning4j_torch" / "csrc" / source
            text = path.read_text()
            labels[name] = body_of(name, text)
            _, kernel, _, anchors = BODIES[labels[name]]
            path.write_text(instrument(text, kernel, anchors))
        out = subprocess.run([sys.executable, "-c", PROBE], cwd=work,
                             env=dict(os.environ, PYTHONPATH=str(work)), capture_output=True,
                             text=True, timeout=900)
        if out.returncode != 0:
            raise RuntimeError(f"probe failed for {root}:\n{out.stdout[-3000:]}\n"
                               f"{out.stderr[-3000:]}")
        line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT "))
        report(str(root), json.loads(line[len("RESULT "):]), labels)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
