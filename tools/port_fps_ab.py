#!/usr/bin/env python3
"""Steady frames/s of two trees of the port on the same card, in turns (A, B, B, A by
default): what one change moves, read within one call, where readings of separate calls
move by several percent from run to run.

    git archive PARENT | tar -x -C ab_parent       # ab_parent/ is git-ignored
    python3 tools/port_fps_ab.py --trees ab_parent . [--order ABBA] [--chunks 5]
        [--out chiprun_out/fps_ab.json]

Each tree is a checkout of the repo (the parent, and this one). Each turn is a process of
its own that imports that tree's ``lcvo_tpu_torch``, builds its kernels, and runs, on the
same corridor frames at 1240x376 (rendered once, first), ``VisualOdometry.run_chunked``
with chunks of 16 for the default configuration, ``configs/reference.yaml``,
``configs/throughput.yaml`` and ``configs/turn_robust.yaml`` at seed 1 (the others at
seed 0), then the streams chunk step at S = 8
(turn_robust): the frames/s over the chunks after the first, and the median ``step``
latency with the pose read back. The streams step takes what that tree's step takes for
its randomness (a tree whose step draws from a ``torch.Generator`` gets one). Prints one
JSON object: each turn's figures and, per path, each tree's median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, CHUNK = 1240, 376, 16

RUNNER = r'''
import json, os, statistics, sys, time
import numpy as np
import torch
from lcvo_tpu_torch import kernels
from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.data.synthetic import SyntheticSequence
from lcvo_tpu_torch.parallel import streams as ps
from lcvo_tpu_torch.pipeline import VisualOdometry

frames = np.load(sys.argv[1])
n_chunks = int(sys.argv[2])
CHUNK = 16
kernels.library()
seq = SyntheticSequence(n_frames=len(frames), width=frames.shape[2], height=frames.shape[1])
out = {}
paths = {"default": (None, 0), "reference": ("configs/reference.yaml", 0),
         "throughput": ("configs/throughput.yaml", 0), "turn_robust": ("configs/turn_robust.yaml", 1)}
n = 7 + n_chunks * CHUNK
for name, (path, seed) in paths.items():
    cfg = load_config(path, overrides={"seed": seed})
    ends = []
    vo = VisualOdometry(cfg, seq.K, device="cuda")
    vo.run_chunked(frames[:n], chunk=CHUNK, on_chunk=lambda s, R, t, ok, ninl: (
        ends.append(time.perf_counter()) if len(ok) == CHUNK else None))
    lat = []
    for f in frames[n: n + 8]:
        t0 = time.perf_counter()
        vo.step(f).R.cpu()
        lat.append((time.perf_counter() - t0) * 1e3)
    out[name] = {"fps": CHUNK * (len(ends) - 1) / (ends[-1] - ends[0]),
                 "step_ms_median": statistics.median(lat)}
cfg = load_config("configs/turn_robust.yaml", overrides={"seed": 1})
S = 8
vos = []
for _ in range(S):
    vo = VisualOdometry(cfg, seq.K, device="cuda")
    vo.bootstrap(list(frames[:7]))
    vos.append(vo)
step = ps.make_multistream_chunk_step(cfg, seq.K, device="cuda")
carry = ps.stack_streams([vo.chunk_carry() for vo in vos])
batch = torch.from_numpy(frames[7: 7 + 4 * CHUNK]).cuda()
if hasattr(ps, "chunk_keys"):
    chains = ps.stream_keys(cfg.seed, S)
    def rand():
        global chains
        chains, keys = ps.chunk_keys(chains, CHUNK)
        return keys
else:
    gen = torch.Generator(device="cuda")
    gen.manual_seed(cfg.seed)
    def rand():
        return gen
ends = []
for k in range(4):
    fr = batch[None, k * CHUNK:(k + 1) * CHUNK].expand(S, -1, -1, -1)
    carry, (R, t, ok, ninl) = step(carry, fr, rand(), frame_idx=k * CHUNK)
    R.cpu()
    ends.append(time.perf_counter())
out["streams_S8"] = {"fps": S * CHUNK * 3 / (ends[-1] - ends[0])}
print("RESULT " + json.dumps(out), flush=True)
'''


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs=2, required=True, metavar=("A", "B"))
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--chunks", type=int, default=5, help="chunks of 16 per path")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from lcvo_tpu_torch.data.synthetic import SyntheticSequence
    import numpy as np

    n = 7 + args.chunks * CHUNK + 8
    seq = SyntheticSequence(n_frames=n, width=W, height=H)
    frames = np.clip(np.rint(np.stack([seq.frame(i) for i in range(n)])), 0, 255).astype(np.uint8)
    trees = {"A": os.path.abspath(args.trees[0]), "B": os.path.abspath(args.trees[1])}
    turns = []
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.npy")
        np.save(path, frames)
        for t in args.order:
            proc = subprocess.run([sys.executable, "-c", RUNNER, path, str(args.chunks)],
                                  cwd=trees[t], capture_output=True, text=True,
                                  env={**os.environ, "PYTHONPATH": trees[t]})
            lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
            if proc.returncode != 0 or not lines:
                sys.stderr.write(proc.stderr[-4000:])
                raise SystemExit(f"turn {t} ({trees[t]}) failed with {proc.returncode}")
            turns.append({"tree": t, **json.loads(lines[-1][len("RESULT "):])})
    medians = {}
    for p in turns[0]:
        if p == "tree":
            continue
        medians[p] = {t: {k: statistics.median(x[p][k] for x in turns if x["tree"] == t)
                          for k in turns[0][p]} for t in "AB"}
        medians[p]["B_over_A_fps"] = medians[p]["B"]["fps"] / medians[p]["A"]["fps"]
    out = {"trees": trees, "order": args.order, "turns": turns, "medians": medians}
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
