"""Serving-shape kernel times of two checkouts of the port, in one run.

    python3 perf_serving_ab.py OTHER_CHECKOUT [REPS]

Runs ``chip_smoke.check_kernels()`` (K1 masked and unmasked, K3, at b=32,
T=200, H=512, bf16 weights; each kernel built from that checkout's own
sources) in a fresh process from the root of each checkout, in turns:
other, this, this, other (REPS times over). Prints each run's kernel
milliseconds and, per kernel, the mean of each side and their ratio.
Needs one CUDA card; two versions are compared only within one run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
PROBE = ("import json, torch, chip_smoke as c\n"
         "torch.backends.cuda.matmul.allow_tf32 = False\n"
         "getattr(c, 'build', lambda: None)()  # older scripts build at first launch\n"
         "r = c.check_kernels()\n"
         "print('RESULT ' + json.dumps({k: v['ms'] for k, v in r.items() if isinstance(v, dict)}))\n")


def run(root: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"probe failed in {root}:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    other = Path(sys.argv[1]).resolve()
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    runs = {"other": [], "this": []}
    for _ in range(reps):
        for side, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
            ms = run(root)
            runs[side].append(ms)
            print(side, json.dumps(ms), flush=True)
    for k in runs["this"][0]:
        a = sum(r[k] for r in runs["other"]) / len(runs["other"])
        b = sum(r[k] for r in runs["this"]) / len(runs["this"])
        print(f"{k}: other {a:.4f} ms, this {b:.4f} ms, this/other {b / a:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
