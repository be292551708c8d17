"""Kernel times of several checkouts of the port, in one run.

    python3 perf_serving_ab.py [--training] OTHER [OTHER ...] [REPS]

Serving mode (the default) runs ``chip_smoke.check_kernels()`` (K1 masked
and unmasked, K3, at b=32, T=200, H=512, bf16 weights); ``--training`` runs
``chip_smoke.check_training_kernels()`` instead (K1 and K3 writing the
reserve, K2 and K4 at the training shape b=64, T=50). Each kernel is built
from that checkout's own sources, in a fresh process from the root of each
checkout, in turns: every other checkout, this one twice, the others in
reverse order (REPS times over). Prints each run's kernel milliseconds and,
per kernel, the mean of each checkout and its ratio to this one. Needs one
CUDA card; versions are compared only within one run.
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
         "{build}\n"
         "r = c.{check}()\n"
         "print('RESULT ' + json.dumps({{k: v['ms'] for k, v in r.items() if isinstance(v, dict)}}))\n")
SERVING = PROBE.format(build="getattr(c, 'build', lambda: None)()  # older scripts build at first launch",
                       check="check_kernels")
TRAINING = PROBE.format(build=("from deeplearning4j_torch.ops import cuda_build, lstm_cell, lstm_fused\n"
                               "cuda_build.build_all([lstm_cell.SOURCE, lstm_cell.BWD_SOURCE, "
                               "lstm_fused.SOURCE, lstm_fused.BWD_SOURCE])"),
                        check="check_training_kernels")


def run(root: Path, probe: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise RuntimeError(f"probe failed in {root}:\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    line = next(l for l in out.stdout.splitlines() if l.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main(argv) -> int:
    probe = TRAINING if "--training" in argv else SERVING
    args = [a for a in argv if a != "--training"]
    reps = int(args.pop()) if args and args[-1].isdigit() else 1
    others = [Path(a).resolve() for a in args]
    if not others:
        raise SystemExit(__doc__)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sides = {"this": HERE, **{str(o): o for o in others}}
    runs = {side: [] for side in sides}
    order = [str(o) for o in others] + ["this", "this"] + [str(o) for o in reversed(others)]
    for _ in range(reps):
        for side in order:
            ms = run(sides[side], probe)
            runs[side].append(ms)
            print(side, json.dumps(ms), flush=True)
    for k in runs["this"][0]:
        b = sum(r[k] for r in runs["this"]) / len(runs["this"])
        print(f"{k}: this {b:.4f} ms")
        for side in map(str, others):
            a = sum(r[k] for r in runs[side]) / len(runs[side])
            print(f"{k}: {side} {a:.4f} ms, {side}/this {a / b:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
