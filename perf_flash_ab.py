"""K6/K7 (flash-attention backward) times of several source directories, in one run.

    python3 perf_flash_ab.py DIR [DIR ...]

Each DIR holds a variant of the port's CUDA sources (``flash_attn_dq.cu``,
``flash_attn_dkv.cu`` and the headers they include), for example a copy of
``deeplearning4j_torch/csrc`` with one change, or that directory of an
older checkout; the C entries must take the arguments this checkout's
wrappers pass. Every variant is built with this checkout's ``nvcc`` flags
into ``build/flash_ab/<i>/`` (all at once), and ptxas's registers and
spills of its wgmma kernels are printed. Then, in turns (DIR order, then
reversed), the wrappers ``dq_block``/``dkv_block`` are pointed at each
variant's libraries, which are held against the plain versions on 18 small
cases (d 64/80/128, causal or not, Tq != Tk, key masks, dropout) and at
b=4 h=8 T=8192 d=64 causal, and timed there (and at bh=16 T=8192 d=128).
PyTorch's ``scaled_dot_product_attention`` backward is timed once at the
end as a yardstick. Needs one CUDA card; compare variants only within one
run.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

from deeplearning4j_torch.ops import cuda_build
from deeplearning4j_torch.ops import flash_attention as fa

SOURCES = (fa.DQ_SOURCE, fa.DKV_SOURCE)


def build(dirs):
    """Compile every variant's two sources at once; returns
    {(i, source): library path}."""
    procs = {}
    for i, d in enumerate(dirs):
        out = cuda_build.BUILD_DIR.parent / "flash_ab" / str(i)
        out.mkdir(parents=True, exist_ok=True)
        for src in SOURCES:
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


def use(libs, i):
    """Point the wrappers at variant i's libraries."""
    for src in SOURCES:
        lib = ctypes.CDLL(str(libs[(i, src)]))
        lib.dl4j_error_string.argtypes = [ctypes.c_int]
        lib.dl4j_error_string.restype = ctypes.c_char_p
        cuda_build._loaded[src] = lib


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


def main() -> int:
    dirs = [Path(x).resolve() for x in sys.argv[1:]]
    if not dirs or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    libs = build(dirs)
    print(f"built {len(dirs)} variants in {time.perf_counter() - t0:.1f} s", flush=True)

    dev, g = torch.device("cuda"), torch.Generator().manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev, torch.bfloat16)

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
    bh, t, d = 32, 8192, 64
    q, k, v, do = (rnd(bh, t, d) for _ in range(4))
    o, lse = fa.flash_fwd_plain(q, k, v, None, True, d ** -0.5)
    full = (q, k, v, None, do, fa.rowwise_delta(do, o), lse, True, d ** -0.5)
    full_ref = (fa.flash_dq_plain(*full), *fa.flash_dkv_plain(*full))
    q2, k2, v2, do2 = (rnd(16, t, 128) for _ in range(4))
    o2, lse2 = fa.flash_fwd_plain(q2, k2, v2, None, True, 128 ** -0.5)
    wide = (q2, k2, v2, None, do2, fa.rowwise_delta(do2, o2), lse2, True, 128 ** -0.5)
    flops = 2 * d * bh * t * (t + 1) // 2        # one product over the visible cells
    for i in list(range(len(dirs))) + list(reversed(range(len(dirs)))):
        use(libs, i)
        worst = 0.0
        for args, ref in small:
            got = (fa.dq_block(*args), *fa.dkv_block(*args))
            torch.cuda.synchronize()
            worst = max(worst, *(rel(a, b) for a, b in zip(got, ref)))
        got = (fa.dq_block(*full), *fa.dkv_block(*full))
        err = max(rel(a, b) for a, b in zip(got, full_ref))
        k6, k7 = cuda_ms(lambda: fa.dq_block(*full), 10), cuda_ms(lambda: fa.dkv_block(*full), 10)
        w6, w7 = cuda_ms(lambda: fa.dq_block(*wide), 5), cuda_ms(lambda: fa.dkv_block(*wide), 5)
        print(f"[{i}] {dirs[i]}: small-case rel err {worst:.2e}, full width {err:.2e} | d=64: "
              f"K6 {k6:.3f} ms ({3 * flops / k6 / 1e9:.0f} TFLOP/s), K7 {k7:.3f} ms "
              f"({4 * flops / k7 / 1e9:.0f} TFLOP/s), sum {k6 + k7:.3f} | d=128 bh=16: K6 {w6:.3f} "
              f"K7 {w7:.3f}", flush=True)
    qs, ks, vs, dos = (x.view(4, 8, t, d).detach().requires_grad_(x is not do) for x in (q, k, v, do))
    out = torch.nn.functional.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    sdpa = cuda_ms(lambda: torch.autograd.grad(out, (qs, ks, vs), dos, retain_graph=True), 10)
    print(f"scaled_dot_product_attention backward (yardstick): {sdpa:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
