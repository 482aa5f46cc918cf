"""Which CUDA graph capture modes capture the port's sharded calls with their NCCL
collectives, at a world of one NCCL rank on one card.

    python3 tools/port_probe_capture_modes.py [--reps 8] [--out chiprun_out/capture_modes.json]

For each of ``global``, ``thread_local`` and ``relaxed`` (``capture_error_mode`` of
``torch.cuda.CUDAGraph.capture_begin``), a process of its own joins a world of one NCCL
rank and ``--reps`` times builds a new mesh's compiled sharded BA and matcher
(``compiled_solver``, ``compiled_matcher``) with that mode in place of the package's
``thread_local``, calls each three times and holds every result to the eager run bit for
bit, on ``chip_smoke.py``'s ``[dist]`` scene. Each mode runs in its own process because
a capture broken by another thread's CUDA call (ProcessGroupNCCL's watchdog) may end the
process; its record then holds the exit code and the end of its output. Prints the
card's name and power limit and one JSON object: per mode and call, how many builds
captured, replayed at every call after, and equalled the eager run, and the errors.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

MODES = ("global", "thread_local", "relaxed")


def _bits_equal(a, b) -> bool:
    import torch
    from torch.utils._pytree import tree_flatten

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _one_mode(mode: str, reps: int) -> dict:
    import torch
    import torch.distributed as dist

    from chip_smoke import DIST_K, DIST_W, _ba_kwargs, _ba_scene, _match_inputs
    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.frontend.match import compiled_matcher
    from lcvo_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from lcvo_tpu_torch.solve.ba.schur import BAProblem
    from lcvo_tpu_torch.solve.ba.sharded import compiled_solver
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dev = init_distributed(f"localhost:{port}", num_processes=1, process_id=0)
    try:
        scene, match, kw = _ba_scene(DIST_W, DIST_K), _match_inputs(), _ba_kwargs(load_config())
        prob = BAProblem(*(torch.from_numpy(scene[k]).to(dev)
                           for k in ("R", "t", "X", "obs", "mask")))
        q = [torch.from_numpy(match[k]).to(dev) for k in ("dq", "vq", "dt", "vt")]
        calls = {"ba_solve_sharded": (lambda mesh: compiled_solver(mesh, **kw), (*prob, None)),
                 "knn_match_ratio_sharded": (compiled_matcher, tuple(q))}
        with disable_graphs():
            mesh = make_mesh(1)
            ref = {name: make(mesh)(*args) for name, (make, args) in calls.items()}
        rec = {name: {"builds": reps, "captured": 0, "replayed_every_call": 0, "equal": 0,
                      "errors": []} for name in calls}
        for _ in range(reps):
            mesh = make_mesh(1)       # a new mesh keeps no compiled step
            for name, (make, args) in calls.items():
                step = make(mesh)
                step.capture_mode = mode
                r = rec[name]
                try:
                    outs = []
                    for _ in range(3):
                        outs.append((step(*args), step.replayed))
                    torch.cuda.synchronize()
                except Exception as e:  # a failed capture is what this probe records
                    r["errors"].append(f"{type(e).__name__}: {str(e)[:300]}")
                    continue
                r["captured"] += step.captures() == 1
                r["replayed_every_call"] += all(rp for _, rp in outs)
                r["equal"] += all(_bits_equal(o, ref[name]) for o, _ in outs)
        return rec
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--out", default=None)
    ap.add_argument("--mode", choices=MODES, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.mode is not None:
        print(json.dumps(_one_mode(args.mode, args.reps)))
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card)
    rep = {"card": card, "reps": args.reps}
    for mode in MODES:
        try:
            p = subprocess.run([sys.executable, os.path.abspath(__file__), "--mode", mode,
                                "--reps", str(args.reps)],
                               capture_output=True, text=True, timeout=300, cwd=ROOT)
        except subprocess.TimeoutExpired as e:
            rep[mode] = {"exit": "timeout", "tail": str(e.stdout or "")[-2000:]}
            continue
        lines = p.stdout.strip().splitlines()
        try:
            rep[mode] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            rep[mode] = {"exit": p.returncode, "tail": (p.stdout + p.stderr)[-2000:]}
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    sys.exit(main())
