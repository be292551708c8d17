"""Flash-attention kernel times of several source directories, in one run:
K5 (forward) and K6/K7 (backward).

    python3 perf_flash_ab.py [--fwd-only] DIR [DIR ...]

Each DIR holds a variant of the port's CUDA sources (``flash_attn_fwd.cu``,
``flash_attn_dq.cu``, ``flash_attn_dkv.cu`` and the headers they include),
for example a copy of ``deeplearning4j_torch/csrc`` with one change, or that
directory of an older checkout; the C entries must take the arguments this
checkout's wrappers pass. The forward written first (the mma.sync body,
64 queries a block) is the ``csrc`` of a commit from before the forward's
wgmma route, unpacked with ``git archive <commit> deeplearning4j_torch/csrc
| tar -x -C build/old``. Every variant is built with this checkout's
``nvcc`` flags into ``build/flash_ab/<i>/`` (all at once), and ptxas's
registers and spills of its wgmma kernels are printed. Then, in turns (DIR
order, then reversed), the wrappers ``flash_fwd`` (and, without
``--fwd-only``, ``dq_block``/``dkv_block``) are pointed at each variant's
libraries, which are held against the plain versions and timed:

- K5 on 48 small cases (d 64/80/128, causal or not, T 64/192/256/320, a key
  mask that pads one batch x head whole, which must come out exactly 0,
  with dropout at offsets near 2^31; and unmasked without dropout, at T=192
  with a negative scale) and at
  b=4 h=8 T=8192 d=64 causal; timed there, at bh=16 T=8192 d=128 and at
  d=64 non-causal, with
  PyTorch's ``scaled_dot_product_attention`` forward timed on the same
  operands in the same turn as a yardstick;
- K6/K7 on 18 small cases (d 64/80/128, causal or not, Tq != Tk, key masks,
  dropout) and at the same full width, timed there and at d=128;
  ``scaled_dot_product_attention``'s backward is timed once at the end.

Needs one CUDA card; compare variants only within one run.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from deeplearning4j_torch.ops import cuda_build
from deeplearning4j_torch.ops import flash_attention as fa

def build(dirs, sources):
    """Compile every variant's sources at once; returns {(i, source):
    library path}."""
    procs = {}
    for i, d in enumerate(dirs):
        out = cuda_build.BUILD_DIR.parent / "flash_ab" / str(i)
        out.mkdir(parents=True, exist_ok=True)
        for src in sources:
            lib = out / f"lib{Path(src).stem}.so"
            cmd = [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib), str(d / src)]
            procs[(i, src)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (i, src), (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {dirs[i] / src}:\n{log[-4000:]}")
        entry = ""
        for line in log.splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            if "wgmma" in entry and ("registers" in line or "spill" in line) or "arning" in line:
                print(f"  [{i}] {src} {entry[:64]}: {line.strip()}")
        libs[(i, src)] = lib
    return libs


def use(libs, i, sources):
    """Point the wrappers at variant i's libraries; returns the forward's
    route for bf16 d=64 (the C export ``dl4j_flash_fwd_wgmma``, which an
    older forward lacks)."""
    for src in sources:
        lib = ctypes.CDLL(str(libs[(i, src)]))
        lib.dl4j_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_error_string.restype = ctypes.c_char_p
        cuda_build._loaded[src] = lib
    fwd = cuda_build._loaded[fa.FWD_SOURCE]
    if not hasattr(fwd, "dl4j_flash_fwd_wgmma"):
        return "mma.sync"
    fwd.dl4j_flash_fwd_wgmma.argtypes = fa._ROUTE_ARGTYPES
    return "wgmma" if fwd.dl4j_flash_fwd_wgmma(1, 64) else "mma.sync"


def cuda_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp(min=1e-30)).item()


def fwd_cases(dev, rnd):
    """K5's small cases with their plain results: (args, (o, lse))."""
    cases = []
    for d in (64, 80, 128):
        for causal in (True, False):
            for t in (64, 192, 256, 320):
                for masked in (True, False):
                    km = None
                    if masked:
                        km = torch.ones((3, t), device=dev)
                        km[1] = 0.0
                        km[0, 30:50] = 0.0
                    rate = 0.2 if masked else 0.0
                    scale = -0.3 if t == 192 and not masked else 0.3  # a negative scale too
                    args = (rnd(3, t, d), rnd(3, t, d), rnd(3, t, d), km, causal, scale, rate,
                            fa.seed3(-99, 2 ** 31 - 70, 5) if rate else None)
                    cases.append((args, fa.flash_fwd_plain(*args)))
    return cases


def check_fwd(cases):
    """Worst o error (relative to the largest entry) and lse error
    (absolute) of K5 over ``cases``, and the cases whose padded batch x
    head is not exactly o = 0, lse = -1e30."""
    worst_o = worst_lse = 0.0
    bad = []
    for args, (o_p, lse_p) in cases:
        o, lse = fa.flash_fwd(*args)
        torch.cuda.synchronize()
        if args[3] is not None and (torch.count_nonzero(o[1]).item()
                                    or not torch.all(lse[1] == -1e30)):
            bad.append(f"T={args[0].shape[1]} d={args[0].shape[2]} causal={args[4]}")
        worst_o = max(worst_o, rel(o, o_p))
        worst_lse = max(worst_lse, (lse - lse_p).abs().max().item())
    return worst_o, worst_lse, bad


def bwd_cases(dev, rnd, g):
    """K6/K7's small cases with their plain results."""
    small = []
    for d in (64, 128, 80):
        for causal in (True, False):
            for tq, tk, masked, rate in ((256, 256, True, 0.2), (192, 320, False, 0.0),
                                         (320, 192, True, 0.2)):
                km = None
                if masked:
                    km = torch.ones((3, tk), device=dev)
                    km[1] = 0.0
                    km[0, 30:90] = 0.0
                args = (rnd(3, tq, d), rnd(3, tk, d), rnd(3, tk, d), km, rnd(3, tq, d),
                        torch.randn((3, tq), generator=g).to(dev),
                        torch.randn((3, tq), generator=g).to(dev) + 5.0, causal, 0.3,
                        fa.seed3(-99, 2 ** 31 - 70, 5) if rate else None, rate)
                small.append((args, (fa.flash_dq_plain(*args), *fa.flash_dkv_plain(*args))))
    return small


def main() -> int:
    fwd_only = "--fwd-only" in sys.argv[1:]
    sources = (fa.FWD_SOURCE,) if fwd_only else (fa.FWD_SOURCE, fa.DQ_SOURCE, fa.DKV_SOURCE)
    dirs = [Path(x).resolve() for x in sys.argv[1:] if x != "--fwd-only"]
    if not dirs or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    libs = build(dirs, sources)
    print(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    dev, g = torch.device("cuda"), torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev, torch.bfloat16)

    small_fwd = fwd_cases(dev, rnd)
    small_bwd = [] if fwd_only else bwd_cases(dev, rnd, g)
    bh, t, d = 32, 8192, 64
    q, k, v, do = (rnd(bh, t, d) for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, None, True, d ** -0.5)
    full = (q, k, v, None, do, fa.rowwise_delta(do, o), lse, True, d ** -0.5)
    full_ref = () if fwd_only else (fa.flash_dq_plain(*full), *fa.flash_dkv_plain(*full))
    q2, k2, v2, do2 = (rnd(16, t, 128) for _ in range(4))
    o2, lse2 = fa.flash_fwd_plain(q2, k2, v2, None, True, 128 ** -0.5)
    wide = (q2, k2, v2, None, do2, fa.rowwise_delta(do2, o2), lse2, True, 128 ** -0.5)
    # SDPA's operands: the same tensors as [b, h, T, d]
    sd64 = [x.view(4, 8, t, d) for x in (q, k, v)]
    sd128 = [x.view(2, 8, t, 128) for x in (q2, k2, v2)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flops = 2 * d * bh * t * (t + 1) // 2        # one product over the visible cells
    flops128 = 2 * 128 * 16 * t * (t + 1) // 2
    times = {i: [] for i in range(len(dirs))}
    for i in list(range(len(dirs))) + list(reversed(range(len(dirs)))):
        route = use(libs, i, sources)
        s_o, s_lse, bad = check_fwd(small_fwd)
        o_k, lse_k = fa.flash_fwd(q, k, v, None, True, d ** -0.5)
        f_o, f_lse = rel(o_k, o), (lse_k - lse).abs().max().item()
        del o_k, lse_k
        k5 = cuda_ms(lambda: fa.flash_fwd(q, k, v, None, True, d ** -0.5), 10)
        y5 = cuda_ms(lambda: sdpa(*sd64, is_causal=True), 10)
        n5 = cuda_ms(lambda: fa.flash_fwd(q, k, v, None, False, d ** -0.5), 5)
        m5 = cuda_ms(lambda: sdpa(*sd64), 5)
        w5 = cuda_ms(lambda: fa.flash_fwd(q2, k2, v2, None, True, 128 ** -0.5), 5)
        z5 = cuda_ms(lambda: sdpa(*sd128, is_causal=True), 5)
        times[i].append((k5, y5, w5, z5, n5, m5))
        print(f"[{i}] {dirs[i]} K5 ({route}): small cases o {s_o:.2e} lse(abs) {s_lse:.2e}, "
              f"full width o {f_o:.2e} lse(abs) {f_lse:.2e} | d=64: K5 {k5:.3f} ms "
              f"({2 * flops / k5 / 1e9:.0f} TFLOP/s), SDPA forward {y5:.3f} | d=128 bh=16: "
              f"K5 {w5:.3f} ({2 * flops128 / w5 / 1e9:.0f} TFLOP/s), SDPA forward {z5:.3f} | "
              f"d=64 non-causal: K5 {n5:.3f} ({4 * flops / n5 / 1e9:.0f} TFLOP/s), SDPA {m5:.3f}"
              + (f" | padded batch x head NOT exactly 0 in {bad}" if bad else ""), flush=True)
        if fwd_only:
            continue
        worst = 0.0
        for args, ref in small_bwd:
            got = (fa.dq_block(*args), *fa.dkv_block(*args))
            torch.cuda.synchronize()
            worst = max(worst, *(rel(a, b) for a, b in zip(got, ref)))
        got = (fa.dq_block(*full), *fa.dkv_block(*full))
        err = max(rel(a, b) for a, b in zip(got, full_ref))
        k6, k7 = cuda_ms(lambda: fa.dq_block(*full), 10), cuda_ms(lambda: fa.dkv_block(*full), 10)
        w6, w7 = cuda_ms(lambda: fa.dq_block(*wide), 5), cuda_ms(lambda: fa.dkv_block(*wide), 5)
        print(f"[{i}] {dirs[i]} K6/K7: small-case rel err {worst:.2e}, full width {err:.2e} | "
              f"d=64: K6 {k6:.3f} ms ({3 * flops / k6 / 1e9:.0f} TFLOP/s), K7 {k7:.3f} ms "
              f"({4 * flops / k7 / 1e9:.0f} TFLOP/s), sum {k6 + k7:.3f} | d=128 bh=16: K6 {w6:.3f} "
              f"K7 {w7:.3f}", flush=True)
    print("K5 means of the two turns (ms): variant, d=64, SDPA d=64, d=128, SDPA d=128, "
          "d=64 non-causal, SDPA d=64 non-causal")
    for i, ts in times.items():
        print(f"  [{i}] {dirs[i].name}: " + " ".join(
            f"{statistics.mean(x[j] for x in ts):.3f}" for j in range(6)))
    if not fwd_only:
        qs, ks, vs, dos = (x.view(4, 8, t, d).detach().requires_grad_(x is not do)
                           for x in (q, k, v, do))
        out = sdpa(qs, ks, vs, is_causal=True)
        sdpa_b = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True), 10)
        print(f"scaled_dot_product_attention backward (yardstick): {sdpa_b:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
