#!/usr/bin/env python3
"""Find the first operation whose stream-0 result differs between the port's batched
step at one stream and at several, and print one JSON object (with ``--out FILE`` also
written there).

    python3 tools/port_streams_divergence.py [--config configs/turn_robust.yaml]
        [--seed 1] [--streams 4] [--width 1240 --height 376] [--device cuda]
        [--out FILE]

One corridor sequence is bootstrapped once by the single-stream path; its state is
stacked S times, stream k is given frame ``gap + 1 + k`` and every stream the same
injected PnP samples, and ``parallel.streams.make_multistream_step`` runs one frame.
A ``TorchDispatchMode`` records the output of every operation that reaches the backend
(the physical ops under ``torch.func.vmap``, the kernel's operator included) in a run
at S = 1, then compares, op by op in the same order:

- a second run at S = 1 (the control: does the step repeat itself bit for bit?);
- the run at S streams: stream 0's slice of each output (the dim that is 1 at S = 1
  and S at S streams; a dim that is S times longer is read as streams merged into it,
  stream 0 first) against the S = 1 output, exactly (NaN equal to NaN).

For the first mismatches it prints the op, its shapes, the largest difference, whether
its tensor inputs (stream 0's slice) were equal, and where in ``lcvo_tpu_torch`` it was
called. Then stream 0's pose after the frame, S streams against one.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_SHOWN = 12


def _tensors(tree) -> list:
    import torch
    from torch.utils._pytree import tree_flatten

    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _stream0(a, b, S: int):
    """Stream 0's part of ``b`` (S streams) in the layout of ``a`` (one stream), and how
    it was found; None where the shapes do not say."""
    if a.shape == b.shape:
        return b, "unbatched"
    if a.dim() != b.dim():
        return None, "rank"
    d = [k for k in range(a.dim()) if a.shape[k] != b.shape[k]]
    if len(d) != 1 or b.shape[d[0]] != S * a.shape[d[0]]:
        return None, "shape"
    return b.narrow(d[0], 0, a.shape[d[0]]), ("stream dim" if a.shape[d[0]] == 1 else "merged dim")


def _equal(a, b) -> bool:
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return bool(torch.all((a == b) | (torch.isnan(a) & torch.isnan(b))))
    return torch.equal(a, b)


def _max_diff(a, b) -> float | None:
    import torch

    if not (a.is_floating_point() or a.dtype in (torch.int32, torch.int64, torch.int16, torch.uint8)):
        return None
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(d), torch.zeros_like(d), d)
    return float(d.max()) if d.numel() else 0.0


def _where() -> tuple:
    """The innermost three frames of the port's own code on the current stack."""
    out = []
    f = sys._getframe(1)
    while f is not None and len(out) < 3:
        name = f.f_code.co_filename
        if f"{os.sep}lcvo_tpu_torch{os.sep}" in name:
            out.append(f"{os.path.relpath(name, ROOT)}:{f.f_lineno} {f.f_code.co_name}")
        f = f.f_back
    return tuple(reversed(out))


def _recorder():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        """Records, for every op that reaches the backend, its key (op and the port's
        call site), its tensor inputs and its tensor outputs (clones)."""

        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            self.ops.append(((str(func), _where()),
                             [t.detach().clone() for t in _tensors((args, kwargs))],
                             [t.detach().clone() for t in _tensors(out)]))
            return out

    return Record


def compare(one, other, S: int) -> dict:
    """Align the two recordings on their keys (a batching rule may decompose an op
    otherwise at another batch size: those runs of ops are not compared), then compare
    stream 0 of each aligned output with the one-stream output."""
    import difflib

    ka = [k for k, _, _ in one.ops]
    kb = [k for k, _, _ in other.ops]
    blocks = difflib.SequenceMatcher(None, ka, kb, autojunk=False).get_opcodes()
    first, n_cmp, n_unread, n_diff, n_unaligned = [], 0, 0, 0, 0
    last_unaligned = None
    for tag, i1, i2, j1, j2 in blocks:
        if tag != "equal":
            n_unaligned += max(i2 - i1, j2 - j1)
            last_unaligned = {"one_stream": [list(k) for k in ka[i1:i2][:4]],
                              "streams": [list(k) for k in kb[j1:j2][:4]]}
            continue
        for i, j in zip(range(i1, i2), range(j1, j2)):
            (name, where), ins_a, outs_a = one.ops[i]
            _, ins_b, outs_b = other.ops[j]
            bad = None
            for k, (a, b) in enumerate(zip(outs_a, outs_b)):
                got, how = _stream0(a, b, S)
                if got is None:
                    n_unread += 1
                    continue
                n_cmp += 1
                if not _equal(a, got) and bad is None:
                    bad = (k, a, b, got, how)
            if bad is None:
                continue
            n_diff += 1
            if len(first) < N_SHOWN:
                k, a, b, got, how = bad
                ins_equal = []
                for x, y in zip(ins_a, ins_b):
                    yx, _ = _stream0(x, y, S)
                    ins_equal.append(None if yx is None else _equal(x, yx))
                first.append({"index": [i, j], "op": name, "where": list(where), "output": k,
                              "read_as": how, "shape_one_stream": list(a.shape),
                              "shape_streams": list(b.shape), "dtype": str(a.dtype),
                              "max_abs_diff": _max_diff(a, got), "inputs_equal": ins_equal,
                              "after_unaligned": last_unaligned})
    return {"ops": [len(ka), len(kb)], "ops_not_aligned": n_unaligned,
            "outputs_compared": n_cmp, "outputs_not_readable": n_unread,
            "ops_differing": n_diff, "first": first,
            "first_with_equal_inputs": next(
                (m for m in first if all(e is not False for e in m["inputs_equal"])), None)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=os.path.join("configs", "turn_robust.yaml"))
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--width", type=int, default=1240)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from lcvo_tpu_torch.config import load_config
    from lcvo_tpu_torch.data.synthetic import SyntheticSequence
    from lcvo_tpu_torch.parallel import streams as ps
    from lcvo_tpu_torch.pipeline import VisualOdometry, uniforms_fn
    from lcvo_tpu_torch.utils.graphs import disable_graphs

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("port_streams_divergence.py: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 2
    cfg = load_config(os.path.join(ROOT, args.config),
                      overrides={"seed": args.seed, "image_width": args.width,
                                 "image_height": args.height})
    S = args.streams
    gap = cfg.bootstrap.frame_gap
    seq = SyntheticSequence(n_frames=gap + 1 + S, width=args.width, height=args.height)
    frames = np.stack([np.clip(np.rint(seq.frame(i)), 0, 255).astype(np.uint8)
                       for i in range(gap + 1 + S)])
    vo = VisualOdometry(cfg, seq.K, device=dev)
    vo.bootstrap(list(frames[: gap + 1]))
    images = torch.from_numpy(frames[gap + 1:]).to(dev)            # stream k: frame gap+1+k
    # every stream draws what stream 0 draws: one key's uniforms, repeated
    n_hyp = cfg.ransac.pnp_hypotheses
    samples = uniforms_fn(n_hyp, dev)(ps.stream_keys(7, 1)).expand(S, -1, -1).contiguous()
    step = ps.make_multistream_step(cfg, seq.K, device=dev)
    Record = _recorder()

    def run(n, mode=None):
        # eager: the recorder sees the ops a replayed graph would hide
        states = ps.stack_streams([vo.state] * n)
        with disable_graphs(), (mode or contextlib.nullcontext()):
            _, res, _ = step(states, images[:n], samples[:n])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        return res

    run(1)                      # warm: constants made on first use, plans
    run(S)
    one, again, many = Record(), Record(), Record()
    res1 = run(1, one)
    run(1, again)
    resS = run(S, many)

    dR = float((res1.R[0] - resS.R[0]).abs().max())
    dt = float((res1.t[0] - resS.t[0]).abs().max())
    out = {"config": args.config, "seed": args.seed, "size": [args.width, args.height],
           "streams": S, "device": str(dev),
           "card": (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], capture_output=True, text=True)
                    .stdout.strip().splitlines() or [""])[0] if dev.type == "cuda" else "cpu",
           "one_stream_again": compare(one, again, 1), "streams_vs_one": compare(one, many, S),
           "stream0_pose_max_abs_diff": {"R": dR, "t": dt},
           "stream0_n_inliers": [int(res1.n_inliers[0]), int(resS.n_inliers[0])]}
    text = json.dumps(out)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
