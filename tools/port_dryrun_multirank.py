#!/usr/bin/env python3
"""Multi-rank dry run of the port: N processes, one rank each, on ``torch.distributed``
(the counterpart of ``__graft_entry__.py::dryrun_multichip``).

    python3 tools/port_dryrun_multirank.py [--nproc 2] [--device cuda|cpu]
        [--backend nccl|gloo] [--timeout 300]

Starts ``--nproc`` ranks (``lcvo_tpu_torch.parallel.launch.run_ranks``). Each builds a
mesh over the world and, on its own part of the streams:

- one multi-stream step with 2 streams per rank (128 x 96 frames of noise, 16 seeded
  tracks per stream); ``agg`` must be the sum over every rank's streams;
- one chunk step with BA on (window 4, ``keyframe_every`` 2, chunk 3);
- one ``ba_solve_sharded`` at 8 landmarks per rank (4 keyframes, exact observations):
  finite, cost not above its start, the landmarks gathered whole on every rank.

Each rank prints ``MULTIRANK-OK rank=<r> world=<N>``; the tool prints the ranks' output
and ``dryrun_multirank(<N>): OK``, and exits non-zero if a rank fails or outlasts
``--timeout`` seconds (every rank is then killed). ``--device`` defaults to ``cuda``
and the backend to the device's (``nccl`` on CUDA, ``gloo`` on the CPU). NCCL holds one
rank per card, so two ranks on one card need ``--backend gloo``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

W, H = 128, 96
SMALL = {
    "image_width": W, "image_height": H,
    "state": {"max_tracks": 64, "max_candidates": 96, "max_new_per_frame": 32},
    "ransac": {"pnp_hypotheses": 64, "e_hypotheses": 64},
    "klt": {"levels": 2, "iters": 4},
}
BA = {"ba": {"enabled": True, "window": 4, "gn_iters": 2, "keyframe_every": 2},
      "triangulation": {"track_refine": True}}
STREAMS_PER_RANK = 2
CHUNK = 3
LANDMARKS_PER_RANK = 8


def _seed_tracks(states, rng, dev):
    """16 valid tracks per stream, the same on every rank (one rng, one seed)."""
    import torch

    S = states.frame_idx.shape[0]
    P = torch.from_numpy(rng.uniform([16, 16], [W - 16, H - 16], (S, 16, 2)).astype(np.float32))
    X = torch.from_numpy(rng.uniform([-2, -1, 4], [2, 1, 12], (S, 16, 3)).astype(np.float32))
    tr = states.tracks
    return states._replace(tracks=tr._replace(
        P=torch.cat([P.to(dev), tr.P[:, 16:]], 1),
        X=torch.cat([X.to(dev), tr.X[:, 16:]], 1),
        valid=torch.cat([torch.ones((S, 16), dtype=torch.bool, device=dev), tr.valid[:, 16:]], 1)))


def rank_main(dev, argv) -> None:
    """One rank of the dry run (``run_ranks`` calls it after ``init_distributed``)."""
    import torch
    import torch.distributed as dist

    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.data.synthetic import make_intrinsics
    from lcvo_tpu_torch.parallel import streams as ps
    from lcvo_tpu_torch.parallel.mesh import (gather_batched_state, make_mesh,
                                              shard_batched_state)
    from lcvo_tpu_torch.solve.ba.schur import BAProblem
    from lcvo_tpu_torch.solve.ba.sharded import ba_solve_sharded

    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(world, axis_names=("data",), device_type=dev.type)
    S = STREAMS_PER_RANK * world
    K = make_intrinsics(W, H)
    rng = np.random.default_rng(0)

    cfg = load_config(overrides=SMALL)
    states = _seed_tracks(ps.make_batched_state(cfg, (H, W), S, dev), rng, dev)
    images = torch.from_numpy(rng.uniform(0, 255, (S, H, W)).astype(np.float32)).to(dev)
    step = ps.make_multistream_step(cfg, K, mesh=mesh, device=dev)
    keys = ps.stream_keys(rank, S)[rank * STREAMS_PER_RANK:(rank + 1) * STREAMS_PER_RANK]
    part, res, agg = step(shard_batched_state(states, mesh), shard_batched_state(images, mesh), keys)
    if res.R.shape != (STREAMS_PER_RANK, 3, 3) or agg["tracked"].shape != ():
        raise AssertionError(f"rank {rank}: a part of {tuple(res.R.shape)}, agg {agg}")
    fleet = gather_batched_state(res, mesh)
    if int(agg["tracked"]) != int(fleet.n_tracked.sum()) or fleet.R.shape[0] != S:
        raise AssertionError(f"rank {rank}: agg {agg} is not the sum over {S} streams")

    cfg_ba = load_config(overrides={**SMALL, **BA})
    st_ba, windows = ps.make_batched_carry(cfg_ba, (H, W), S, dev)
    carry = (_seed_tracks(st_ba, rng, dev), windows)
    frames = torch.from_numpy(rng.uniform(0, 255, (S, CHUNK, H, W)).astype(np.float32)).to(dev)
    chunk_step = ps.make_multistream_chunk_step(cfg_ba, K, mesh=mesh, device=dev)
    chunk_keys = ps.chunk_keys(ps.stream_keys(rank, S), CHUNK)[1]
    carry, (Rs, ts, _, _) = chunk_step(
        shard_batched_state(carry, mesh), shard_batched_state(frames, mesh),
        chunk_keys[rank * STREAMS_PER_RANK:(rank + 1) * STREAMS_PER_RANK], frame_idx=0)
    if Rs.shape != (STREAMS_PER_RANK, CHUNK, 3, 3) or int(carry[1].head[0]) != 1:
        raise AssertionError(f"rank {rank}: chunk step gave R {tuple(Rs.shape)}, "
                             f"ring head {carry[1].head.tolist()}")

    Wb, Kb = 4, LANDMARKS_PER_RANK * world
    Xb = torch.from_numpy(rng.uniform([-2, -1, 4], [2, 1, 10], (Kb, 3)).astype(np.float32)).to(dev)
    Rb = torch.eye(3, device=dev).expand(Wb, 3, 3).contiguous()
    tb = torch.tensor([[-0.3 * w, 0.0, 0.0] for w in range(Wb)], device=dev)
    pb = torch.einsum("wij,kj->wki", Rb, Xb) + tb[:, None, :]
    prob = BAProblem(R=Rb, t=tb, X=Xb, obs=pb[..., :2] / pb[..., 2:3],
                     mask=torch.ones((Wb, Kb), dtype=torch.bool, device=dev))
    out = ba_solve_sharded(prob, mesh, axis="data", iters=2, n_fix=2)
    if out.X.shape != (Kb, 3) or not bool(torch.isfinite(out.X).all()) or not bool(out.cost <= out.cost0):
        raise AssertionError(f"rank {rank}: sharded BA gave X {tuple(out.X.shape)}, "
                             f"cost {float(out.cost)} from {float(out.cost0)}")
    print(f"MULTIRANK-OK rank={rank} world={world}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, help="nccl or gloo (default: the device's)")
    ap.add_argument("--timeout", type=float, default=300.0, help="seconds for all the ranks")
    args = ap.parse_args(argv)

    from lcvo_tpu_torch.parallel.launch import run_ranks

    outs = run_ranks("tools/port_dryrun_multirank.py:rank_main", args.nproc,
                     device=args.device, backend=args.backend, timeout=args.timeout)
    for r, out in enumerate(outs):
        print(f"--- rank {r}\n{out.rstrip()}")
        if f"MULTIRANK-OK rank={r} world={args.nproc}" not in out:
            print(f"rank {r} did not finish", file=sys.stderr)
            return 1
    print(f"dryrun_multirank({args.nproc}): OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
