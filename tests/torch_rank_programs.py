"""Rank programs of the port's multi-process tests.

``lcvo_tpu_torch.parallel.launch.run_ranks("tests/torch_rank_programs.py:<name>", n,
[in, out], device="cpu")`` runs one of these on each of n gloo ranks. They import only
numpy, torch and ``lcvo_tpu_torch``; the tests build the inputs in the pytest process
(``.npz``, or ``torch.save`` for pytrees of the port's NamedTuples), and each rank writes
what it got to ``<out>_rank<r>.npz``. The JAX side of every comparison stays in the
pytest process.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten

from lcvo_tpu_torch.config import load_config
from lcvo_tpu_torch.frontend.match import (compiled_matcher, knn_match_ratio,
                                           knn_match_ratio_sharded)
from lcvo_tpu_torch.parallel import mesh as mesh_mod
from lcvo_tpu_torch.parallel import streams as ps
from lcvo_tpu_torch.parallel.mesh import (all_gather, gather_batched_state, make_mesh,
                                          mesh_from_config, psum, shard_batched_state)
from lcvo_tpu_torch.solve.ba.schur import BAProblem, ba_solve
from lcvo_tpu_torch.solve.ba.sharded import ba_solve_sharded, compiled_solver
from lcvo_tpu_torch.utils.graphs import compile_step, place


def _save(out: str, **arrays) -> None:
    np.savez(f"{out}_rank{dist.get_rank()}.npz", **arrays)


def _leaves(tree) -> list:
    return [x.cpu().numpy() for x in tree_flatten(tree)[0] if x is not None]


def _raises(fn, exc) -> bool:
    try:
        fn()
    except exc:
        return True
    return False


def sharded_ba(dev, argv) -> None:
    """Every scene of ``<in>.npz`` (keys ``<scene>/{R,t,X,obs,mask,iters}``, optional
    ``<scene>/fix_rows``) through ``ba_solve_sharded`` over the world, and through
    ``ba_solve`` on this rank; then a landmark count that does not divide."""
    src, out = argv
    d = np.load(src)
    mesh = make_mesh(dist.get_world_size(), device_type=dev.type)
    got = {}
    for scene in sorted({k.split("/")[0] for k in d.files}):
        prob = BAProblem(*(torch.from_numpy(d[f"{scene}/{k}"]).to(dev)
                           for k in ("R", "t", "X", "obs", "mask")))
        kw = {"iters": int(d[f"{scene}/iters"]), "n_fix": 2}
        if f"{scene}/fix_rows" in d.files:
            kw["fix_rows"] = torch.from_numpy(d[f"{scene}/fix_rows"]).to(dev)
        for tag, res in (("sharded", ba_solve_sharded(prob, mesh, **kw)), ("one", ba_solve(prob, **kw))):
            for f in res._fields:
                got[f"{scene}/{tag}/{f}"] = getattr(res, f).cpu().numpy()
        odd = prob._replace(X=prob.X[:-1], obs=prob.obs[:, :-1], mask=prob.mask[:, :-1])
        got[f"{scene}/odd_k_raised"] = np.array(
            mesh.shape["data"] == 1 or _raises(lambda: ba_solve_sharded(odd, mesh, **kw), ValueError))
    _save(out, **got)


def sharded_match(dev, argv) -> None:
    """``knn_match_ratio_sharded`` over the world on ``<in>.npz`` (``dq``, ``vq``,
    ``dt``, ``vt``), ``knn_match_ratio`` on this rank, and a query count that does not
    divide."""
    src, out = argv
    d = np.load(src)
    q, vq, t, vt = (torch.from_numpy(d[k]).to(dev) for k in ("dq", "vq", "dt", "vt"))
    mesh = make_mesh(device_type=dev.type)
    idx, ok = knn_match_ratio_sharded(mesh, q, vq, t, vt)
    idx1, ok1 = knn_match_ratio(q, vq, t, vt)
    odd = _raises(lambda: knn_match_ratio_sharded(mesh, q[:-1], vq[:-1], t, vt), ValueError)
    _save(out, idx=idx.cpu().numpy(), ok=ok.cpu().numpy(), idx_one=idx1.cpu().numpy(),
          ok_one=ok1.cpu().numpy(), odd_q_raised=np.array(odd))


def collectives(dev, argv) -> None:
    """What the process group and the mesh helpers give on this rank: rank, world size,
    device, ``psum``, ``all_gather`` order, a shard/gather round trip of a tree with a
    leaf that does not divide, and the mesh sizes that ``make_mesh`` refuses."""
    (out,) = argv
    rank, world = dist.get_rank(), dist.get_world_size()
    mesh = make_mesh(device_type=dev.type)
    tree = {"split": torch.arange(6 * world, device=dev).reshape(2 * world, 3),
            "flag": torch.tensor([True, False] * world, device=dev),
            "odd": torch.arange(2 * world + 1, device=dev).float(), "none": None}
    part = shard_batched_state(tree, mesh)
    back = gather_batched_state({k: part[k] for k in ("split", "flag")}, mesh)
    _save(out, rank=np.array(rank), world=np.array(world), device=np.array(str(dev)),
          mesh_shape=np.array(mesh.shape["data"]), index=np.array(mesh.index("data")),
          psum=psum(torch.tensor(float(rank + 1), device=dev), mesh).cpu().numpy(),
          gathered=all_gather(torch.full((2,), rank, device=dev), mesh).cpu().numpy(),
          part_split=part["split"].cpu().numpy(), part_odd=part["odd"].cpu().numpy(),
          part_none=np.array(part["none"] is None),
          round_trip=np.array(torch.equal(back["split"], tree["split"])
                              and torch.equal(back["flag"], tree["flag"])),
          bigger_raised=np.array(_raises(lambda: make_mesh(2 * world, device_type=dev.type),
                                         RuntimeError)),
          shape_raised=np.array(_raises(lambda: make_mesh(world, shape=(world, 2),
                                                          axis_names=("a", "b"),
                                                          device_type=dev.type), RuntimeError)))


def streams(dev, argv) -> None:
    """This rank's part of the two multi-stream cases of ``<in>.pt`` (see
    ``tests/test_torch_streams.py``): the BA chunk step over a mesh of the world, and the
    step with the mesh from ``runtime.mesh_shape`` (with injected samples and with a
    generator); and whether a mesh of another size than the world is refused."""
    src, out = argv
    d = torch.load(src, weights_only=False)
    world = dist.get_world_size()
    mesh = make_mesh(world, axis_names=("data",), device_type=dev.type)
    got = {}

    c = d["chunk"]
    cfg = load_config(overrides=c["overrides"])
    S = c["frames"].shape[0]
    m, k = S // world, mesh.index("data")
    step = ps.make_multistream_chunk_step(cfg, c["K"], mesh=mesh, axis="data", device=dev)
    carry, outs = step(shard_batched_state(c["carry"], mesh), shard_batched_state(c["frames"], mesh),
                       shard_batched_state(c["samples"], mesh),
                       frame_idx=c["frame_idx"][k * m:(k + 1) * m])
    for i, x in enumerate(_leaves(carry)):
        got[f"chunk/carry/{i}"] = x
    for name, x in zip(("R", "t", "pose_ok", "n_inliers"), outs):
        got[f"chunk/{name}"] = x.cpu().numpy()

    s = d["step"]
    mcfg = load_config(overrides=s["overrides"])
    step = ps.make_multistream_step(mcfg, s["K"], device=dev)
    states, images = shard_batched_state(s["states"], mesh), shard_batched_state(s["images"], mesh)
    out_states, res, agg = step(states, images, shard_batched_state(s["samples"], mesh))
    for i, x in enumerate(_leaves(out_states)):
        got[f"step/states/{i}"] = x
    for f in res._fields:
        got[f"step/res/{f}"] = getattr(res, f).cpu().numpy()
    for key, v in agg.items():
        got[f"step/agg/{key}"] = v.cpu().numpy()
    m, k = s["states"].frame_idx.shape[0] // world, mesh.index("data")
    keys = ps.stream_keys(3, m * world)[k * m:(k + 1) * m]
    out_k, res_k, _ = step(states, images, keys)
    got["keys/R"], got["keys/t"] = res_k.R.cpu().numpy(), res_k.t.cpu().numpy()
    got["keys/frame_idx"] = out_k.frame_idx.cpu().numpy()
    got["keys/frame_idx_in"] = states.frame_idx.cpu().numpy()

    bad = load_config(overrides={**s["overrides"], "runtime": {"mesh_shape": [2 * world]}})
    got["mesh_of_another_size_raised"] = np.array(
        _raises(lambda: mesh_from_config(bad, device_type=dev.type), RuntimeError))
    _save(out, **got)


def fail_on_one_rank(dev, argv) -> None:
    """Rank 1 raises; rank 0 waits for it in a collective that never completes."""
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    dist.all_reduce(torch.ones(1, device=dev))


class _StandIn:
    """``tests/test_torch_graphs.py``'s stand-in for the CUDA capture (the capture runs
    the body once and the first replay hands its result back; later replays run the body
    on the graph's buffers and copy into the outputs of the capture), counting the
    captures, the replays and the collectives the captured body makes."""

    def __init__(self, counter):
        self.counter, self.captures, self.replays, self.collectives = counter, 0, 0, 0

    def warmup(self, run):
        run()

    def capture(self, body):
        before = self.counter[0]
        outs = body()
        self.captures += 1
        self.collectives += self.counter[0] - before
        return [body, outs, True], {}

    def replay(self, handle):
        self.replays += 1
        body, outs, first = handle
        if first:
            handle[2] = False
            return outs
        for o, n in zip(tree_flatten(outs)[0], tree_flatten(body())[0]):
            if torch.is_tensor(o) and o is not n:
                o.copy_(n)
        return outs


def _count_collectives() -> list:
    """Wrap the collectives the mesh helpers call so that each call adds one to the
    returned counter."""
    counter = [0]

    def counting(fn):
        def wrapped(*a, **k):
            counter[0] += 1
            return fn(*a, **k)
        return wrapped

    for name in ("all_reduce", "all_gather_into_tensor"):
        setattr(dist, name, counting(getattr(dist, name)))
    return counter


@contextlib.contextmanager
def _as_on_nccl(standin):
    """The sharded calls made inside are made as on NCCL (``capturable`` true) and their
    compiled steps capture through ``standin`` in place of the CUDA capture: a gloo
    collective runs inside the stand-in's captured body as an NCCL one runs inside the
    graph."""
    patches = [(mesh_mod, "capturable", lambda mesh, axis="data": True),
               (ps, "capturable", lambda mesh, axis="data": True),
               (mesh_mod, "compile_step", functools.partial(compile_step, capture=standin)),
               (ps, "compile_step", functools.partial(compile_step, capture=standin))]
    saved = [(m, name, getattr(m, name)) for m, name, _ in patches]
    for m, name, value in patches:
        setattr(m, name, value)
    try:
        yield
    finally:
        for m, name, value in saved:
            setattr(m, name, value)


def sharded_graphs(dev, argv) -> None:
    """The three compiled sharded calls on gloo, eager as the backend decides and made as
    on NCCL through the capture stand-in (3 calls each): ``ba_solve_sharded`` on ``<in>.pt``'s ``ba``
    problem, ``knn_match_ratio_sharded`` on its ``match`` inputs and the mesh
    ``make_multistream_step`` on its ``step`` case (this rank's part of the streams);
    each result, whether it replayed, the stand-in's captures, replays and the
    collectives inside the captured body; and ``all_gather`` against a gather into a list
    of tensors, for three dtypes."""
    src, out = argv
    d = torch.load(src, weights_only=False)
    counter = _count_collectives()
    world = dist.get_world_size()
    mesh = make_mesh(world, device_type=dev.type)
    got = {}

    def keep(tag, tree):
        for i, x in enumerate(_leaves(tree)):
            got[f"{tag}/{i}"] = x

    def through_standin(tag, make, call):
        standin = _StandIn(counter)
        mesh._compiled.clear()      # the eager steps the mesh keeps give way to new ones
        with _as_on_nccl(standin):
            step = make()
        for k in range(3):
            keep(f"{tag}/standin{k}", call(step))
            # the streams step keeps its compiled step as ``step.compiled``
            got[f"{tag}/standin{k}_replayed"] = np.array(getattr(step, "compiled", step).replayed)
        got[f"{tag}/captures"] = np.array(standin.captures)
        got[f"{tag}/replays"] = np.array(standin.replays)
        got[f"{tag}/collectives_in_capture"] = np.array(standin.collectives)

    prob = BAProblem(*(x.to(dev) for x in d["ba"]["problem"]))
    kw = d["ba"]["kw"]
    keep("ba/eager", ba_solve_sharded(prob, mesh, **kw))
    got["ba/eager_replayed"] = np.array(compiled_solver(mesh, **kw).replayed)
    keep("ba/one", ba_solve(prob, **kw))
    through_standin("ba", lambda: compiled_solver(mesh, **kw), lambda step: step(*prob, None))

    q = [x.to(dev) for x in d["match"]]
    keep("match/eager", knn_match_ratio_sharded(mesh, *q))
    got["match/eager_replayed"] = np.array(compiled_matcher(mesh).replayed)
    keep("match/one", knn_match_ratio(*q))
    through_standin("match", lambda: compiled_matcher(mesh), lambda step: step(*q))

    s = d["step"]
    cfg = load_config(overrides=s["overrides"])
    states, images, samples = (shard_batched_state(s[k], mesh) for k in ("states", "images", "samples"))
    eager = ps.make_multistream_step(cfg, s["K"], mesh=mesh, device=dev)
    keep("step/eager", eager(place(None, states), images, samples))
    got["step/eager_replayed"] = np.array(eager.compiled.replayed)
    got["step/eager_sum_in_graph"] = np.array(eager.sum_in_graph)
    sums = {}

    def make_step():
        step = ps.make_multistream_step(cfg, s["K"], mesh=mesh, device=dev)
        sums["in_graph"] = step.sum_in_graph
        return step

    through_standin("step", make_step, lambda step: step(place(None, states), images, samples))
    got["step/standin_sum_in_graph"] = np.array(sums["in_graph"])

    for dtype in (torch.float32, torch.int64, torch.bool):
        x = (torch.arange(6, device=dev).reshape(3, 2) * (dist.get_rank() + 1)).to(dtype)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        got[f"gather/{dtype}"] = np.array(torch.equal(all_gather(x, mesh), torch.cat(parts)))
    _save(out, **got)
