"""Start the ranks of one program on this machine, one process each.

    outputs = run_ranks("tools/port_dryrun_multirank.py:rank_main", nproc=2,
                        device="cpu", timeout=120)

Each rank runs ``python -m lcvo_tpu_torch.parallel.launch``, which joins the process
group through :func:`~lcvo_tpu_torch.parallel.mesh.init_distributed` (a ``file://``
store in a fresh temporary directory unless ``init`` names another rendezvous), calls
the target ``fn(device, argv)`` and leaves the group. The target is
``path/to/file.py:function`` or ``package.module:function``. The ranks' output goes to
files, not pipes, so a rank that prints much never blocks. When a rank fails, or the
time limit passes, every rank still running is killed: none is left behind.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_ranks(target: str, nproc: int, argv=(), device: str = "cuda",
              backend: str | None = None, timeout: float = 300.0,
              init: str | None = None) -> list[str]:
    """Run ``target`` on ``nproc`` ranks and return each rank's output (stdout and
    stderr), in rank order. Raises ``RuntimeError`` with the ranks' output when a rank
    exits non-zero or the ranks outlast ``timeout`` seconds. Each rank computes on one
    thread: the ranks share the machine's cores."""
    work = tempfile.mkdtemp(prefix="lcvo_ranks_")
    env = dict(os.environ)
    env.pop("LOCAL_RANK", None)         # the device follows the rank here
    env["PYTHONPATH"] = os.pathsep.join([REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    env["OMP_NUM_THREADS"] = "1"
    init = init or f"file://{os.path.join(work, 'store')}"
    logs, procs = [], []
    try:
        for r in range(nproc):
            logs.append(open(os.path.join(work, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lcvo_tpu_torch.parallel.launch", "--target", target,
                 "--nproc", str(nproc), "--rank", str(r), "--init", init, "--device", device,
                 "--backend", backend or "", "--", *argv],
                stdout=logs[-1], stderr=subprocess.STDOUT, env=env, cwd=REPO))
        deadline = time.monotonic() + timeout
        why = None
        while why is None and any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs):
                why = "a rank failed"
            elif time.monotonic() > deadline:
                why = f"the ranks outlasted {timeout} s"
            else:
                time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
        if why is None and any(p.returncode for p in procs):
            why = "a rank failed"
        if why is not None:
            tails = "\n".join(f"--- rank {r} (rc {p.returncode}):\n{o[-3000:]}"
                              for r, (p, o) in enumerate(zip(procs, outs)))
            raise RuntimeError(f"{target} on {nproc} ranks: {why}\n{tails}")
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(work, ignore_errors=True)


def _load(target: str):
    where, _, name = target.rpartition(":")
    if where.endswith(".py"):
        spec = importlib.util.spec_from_file_location(
            os.path.splitext(os.path.basename(where))[0], os.path.join(REPO, where))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    else:
        module = importlib.import_module(where)
    return getattr(module, name)


def _rank_main(argv: list[str]) -> None:
    ap = argparse.ArgumentParser(description="one rank of run_ranks")
    ap.add_argument("--target", required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default="")
    ap.add_argument("rest", nargs="*")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from lcvo_tpu_torch.parallel.mesh import init_distributed

    torch.set_num_threads(1)
    dev = init_distributed(args.init, args.nproc, args.rank, args.backend or None, args.device)
    try:
        _load(args.target)(dev, args.rest)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
