"""Stream-parallel execution: many independent VO streams, one set of launches per
device (port of ``lcvo_tpu/parallel/streams.py``).

The reference is sequential over one camera stream, so the scale-out axis is across
streams: sequence replays, multi-camera rigs, benchmark sweeps. The JAX package
``jax.vmap``\\ s the single-stream step over a leading stream dim. Here the same
single-stream functions (``pipeline.make_process_frame``, ``pipeline.make_ba_step``)
run under ``torch.func.vmap``: every op of the step runs once for all S streams, and
the block-extraction kernel has a batching rule that makes the S streams' calls one
launch of its layered entry (``ops/klt_extract.py``). On a card that is idle 88-95% of a
frame because the host cannot launch faster, S streams cost about the launches of one.

What the step obeys so that vmap takes it: no write into a freshly made buffer (an
out-of-place form instead: ``F.pad``, ``torch.where``), and ``None`` for the ``None``
leaves of a state (``prev_desc`` outside sift-sift mode) in ``in_dims``/``out_dims``.

Decisions, against the JAX package's batched step:

- **Randomness.** The JAX package's: the steps take keys, (S, 2) a frame and
  (S, chunk, 2) a chunk, made as its callers make them (:func:`stream_keys`: stream s
  keyed by ``split(PRNGKey(seed), S)[s]``; :func:`chunk_keys`: each stream's chain split
  per chunk as the single-stream host loop splits its own). The uniforms of all the keys
  are made on the device in one call (``pipeline.uniforms_fn``), so the launches do not
  grow with S, and stream s draws what the JAX package's stream s draws. Tests inject
  the draws as a tensor instead, (S, n_hyp, 3) for a step and (S, chunk, n_hyp, 3) for
  a chunk: uniforms (floating point) or PnP minimal sets (integer).
- **The BA cadence.** One host mirror of ``frame_idx`` per stream (the caller's, as in
  ``pipeline.make_chunk_fn``). At a frame where any stream is on its cadence, the
  vmapped ``ba_step`` runs on all streams and ``torch.where`` over the stream dim keeps
  its result only for the streams on cadence, decided on the device from
  ``state.frame_idx`` (which the mirrors equal). That is what the JAX package's vmapped
  ``lax.cond`` computes: under vmap a cond with a batched predicate is a select of both
  branches. When all mirrors are equal every stream is on cadence at once and no
  select runs.
- As in the JAX package's batched chunk step there is no re-bootstrap inside: a
  collapsed stream's ``health`` is the caller's to read.
- Nothing reads back to the host inside a batched step or chunk.
- On the card the vmapped step and the vmapped keyframe step are CUDA graphs
  (``utils/graphs.py``, where the JAX package jits them), captured per shape at their
  first call, with the state (and the window) donated as ``cfg.runtime.donate_state``
  says; the chunk step is a Python loop of their replays. ``torch.func.vmap`` runs at
  the capture only, and the layered kernel's launches are counted per replay.
- With a mesh (:mod:`lcvo_tpu_torch.parallel.mesh`) the step is SPMD, one process per
  device: each rank passes its own part of the streams
  (:func:`~lcvo_tpu_torch.parallel.mesh.shard_batched_state`), runs the vmapped step
  on its device and gets its part back. The one value that crosses ranks is ``agg``,
  summed over the mesh axis (the JAX package's replicated ``agg``). Without a mesh the
  step is the batched step on one device. On NCCL the sum over ranks is inside the
  compiled step, captured with it, where the JAX package's ``out_shardings`` puts its
  AllReduce; on gloo, whose collectives cannot be captured, it runs after the replay
  (``parallel/mesh.py::capturable``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_map

from lcvo_tpu_torch.core import state as st
from lcvo_tpu_torch.core.state import resolve_device
from lcvo_tpu_torch.parallel.mesh import capturable, mesh_from_config, psum
from lcvo_tpu_torch.pipeline import (draws_of, frame_step, make_ba_step, make_process_frame,
                                     uniforms_fn)
from lcvo_tpu_torch.solve.ba import window as win_mod
from lcvo_tpu_torch.utils import jax_random
from lcvo_tpu_torch.utils.graphs import compile_step


def _dims(tree, dim=0):
    """``in_dims``/``out_dims`` for a pytree: ``dim`` for each tensor, None for None."""
    return tree_map(lambda x: None if x is None else dim, tree)


def _broadcast(tree, n: int):
    return tree_map(lambda x: None if x is None else x[None].expand((n,) + x.shape).clone(),
                    tree)


def stream_keys(seed: int, n_streams: int) -> np.ndarray:
    """Each stream's key, as the JAX package's callers make them:
    ``split(PRNGKey(seed), n_streams)``, (S, 2) uint32."""
    return jax_random.split(jax_random.PRNGKey(seed), n_streams)


def chunk_keys(keys: np.ndarray, chunk: int) -> tuple[np.ndarray, np.ndarray]:
    """The keys of one chunk for every stream: each stream's chain ``keys`` (S, 2) split
    as the single-stream host loop splits its own per chunk (``key, k = split(key)``,
    then ``split(k, chunk)``). Returns the chains' next keys (S, 2) and the chunk's keys
    (S, chunk, 2)."""
    nxt = jax_random.split(keys)
    return nxt[:, 0], jax_random.split(nxt[:, 1], chunk)


def stack_streams(trees: list):
    """One batched pytree from S single-stream ones (states, windows, carries)."""
    return tree_map(lambda *xs: None if xs[0] is None else torch.stack(xs), *trees)


def select_stream(tree, s: int):
    """Stream ``s`` of a batched pytree."""
    return tree_map(lambda x: None if x is None else x[s], tree)


def make_batched_state(cfg, image_shape, n_streams: int, device="cuda") -> st.VOState:
    """Empty VO state with a leading stream dimension on every leaf."""
    return _broadcast(st.make_vo_state(cfg, image_shape, device), n_streams)


def make_batched_carry(cfg, image_shape, n_streams: int, device="cuda"):
    """Stream-batched carry for the chunked path: the VO state, plus a batched BA
    keyframe window when BA is enabled (the carry of ``pipeline.make_chunk_fn``)."""
    states = make_batched_state(cfg, image_shape, n_streams, device)
    if not cfg.ba.enabled:
        return states
    w0 = win_mod.make_window(cfg.ba.window, cfg.state.max_tracks, device)
    return states, _broadcast(w0, n_streams)


def _mesh_of(cfg, mesh, axis: str, dev: torch.device):
    """``(mesh, axis)``: the mesh passed, else the one ``cfg.runtime.mesh_shape`` gives
    (its first axis the stream axis), else ``(None, axis)``."""
    if mesh is None and tuple(cfg.runtime.mesh_shape):
        mesh = mesh_from_config(cfg, device_type=dev.type)
        axis = mesh.axis_names[0]
    return mesh, axis


def _pool(dev: torch.device):
    """One graph memory pool for the compiled steps made by one ``make_*`` call (None off
    the card)."""
    return torch.cuda.graph_pool_handle() if dev.type == "cuda" else None


def _vmapped_frame(pf, states, images, draws):
    """``process_frame`` over the stream dim, stream s drawing from ``draws[s]``
    (n_hyp, 3): uniforms, or injected minimal sets (integer)."""
    d = _dims(states)
    return torch.func.vmap(frame_step(pf), in_dims=(d, 0, 0), out_dims=(d, 0))(
        states, images, draws)


def make_multistream_step(cfg, K, mesh=None, axis: str = "data", device="cuda"):
    """The multi-stream step.

    Returns ``step(states, images, keys) -> (states, results, agg)``: every argument and
    result has a leading stream dim; ``keys`` (S, 2) are the streams' step keys (numpy
    uint32 or an integer tensor), or a tensor (S, n_hyp, 3) of injected draws; ``agg``
    holds the sums over the streams of ``n_tracked``, ``n_inliers``, ``n_promoted`` and
    ``pose_ok`` as 0-d tensors on the device.

    With a mesh every argument and result is this rank's part of the streams, and
    ``agg`` holds the sums over the streams of all the ranks along ``axis``. When
    ``mesh`` is None and ``cfg.runtime.mesh_shape`` is set, the mesh comes from the
    config (:func:`lcvo_tpu_torch.parallel.mesh.mesh_from_config`) with its first axis
    as the stream axis.

    ``step.compiled`` is the compiled step (its ``replayed``: whether the last call
    replayed a graph) and ``step.sum_in_graph`` whether the sum over ranks is inside it
    (a mesh on NCCL)."""
    dev = resolve_device(device)
    mesh, axis = _mesh_of(cfg, mesh, axis, dev)
    pf = make_process_frame(cfg, K, dev)
    in_graph = mesh is not None and capturable(mesh, axis)
    uniforms = uniforms_fn(cfg.ransac.pnp_hypotheses, dev, dict(pool=_pool(dev)))

    def fleet(agg):
        # the fleet's sums: one collective for the four
        total = psum(torch.stack(list(agg.values())), mesh, axis)
        return dict(zip(agg, total.unbind()))

    def local(states, images, draws):
        states, results = _vmapped_frame(pf, states, images, draws)
        agg = {
            "tracked": torch.sum(results.n_tracked),
            "inliers": torch.sum(results.n_inliers),
            "promoted": torch.sum(results.n_promoted),
            "pose_ok": torch.sum(results.pose_ok.to(torch.int32)),
        }
        return states, results, fleet(agg) if in_graph else agg

    compiled = compile_step(local, donate=cfg.runtime.donate_state, pool=_pool(dev),
                            name="multistream_step",
                            capture_mode="thread_local" if in_graph else "global")

    def step(states, images, keys):
        states, results, agg = compiled(states, images, draws_of(keys, uniforms, 2))
        if mesh is not None and not in_graph:
            agg = fleet(agg)
        return states, results, agg

    step.compiled, step.sum_in_graph = compiled, in_graph
    return step


def _select(on: torch.Tensor, new, old):
    """Per stream: ``new`` where ``on`` (S,) is set, else ``old``, leaf by leaf."""
    def pick(a, b):
        if a is None:
            return None
        return torch.where(on.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return tree_map(pick, new, old)


def make_multistream_chunk_step(cfg, K, mesh=None, axis: str = "data", device="cuda"):
    """Stream-parallel form of the production chunk loop (``pipeline.make_chunk_fn``):
    per frame the vmapped ``process_frame`` and, on the BA cadence, the vmapped keyframe
    step.

    Returns ``chunk_step(carry, frames (S, chunk, H, W), keys (S, chunk, 2),
    frame_idx=None) -> (carry', (R (S, chunk, 3, 3), t (S, chunk, 3), pose_ok (S, chunk),
    n_inliers (S, chunk)))`` with ``carry`` = states, or ``(states, windows)`` under BA,
    as the JAX package's. ``keys`` may also be a tensor (S, chunk, n_hyp, 3) of injected
    draws. ``frame_idx``: the streams' ``state.frame_idx`` at the start
    of the chunk as Python ints (one for all, or one per stream), the caller's mirror;
    left out, it is read from the device once, which waits for it.

    With a mesh (passed, or from ``cfg.runtime.mesh_shape``) every argument and result
    is this rank's part of the streams, ``frame_idx`` included. Nothing in the chunk
    step crosses streams, so it makes no collective."""
    ba = cfg.ba.enabled
    every = cfg.ba.keyframe_every
    dev = resolve_device(device)
    _mesh_of(cfg, mesh, axis, dev)      # a mesh from the config must fit the world, as in the step
    pf = make_process_frame(cfg, K, dev)
    ba_step = make_ba_step(cfg, K, dev) if ba else None
    kw = dict(donate=cfg.runtime.donate_state, pool=_pool(dev))
    frame = compile_step(lambda states, images, u: _vmapped_frame(pf, states, images, u),
                         name="multistream_frame", **kw)
    uniforms = uniforms_fn(cfg.ransac.pnp_hypotheses, dev, dict(pool=kw["pool"]))

    def keyframes(carry, select):
        """The vmapped keyframe step on every stream; ``select``: kept only for the
        streams on cadence, decided on the device from ``state.frame_idx``."""
        states, windows = carry
        d, dw = _dims(states), _dims(windows)
        new_states, new_windows, _ = torch.func.vmap(
            ba_step, in_dims=(d, dw), out_dims=(d, dw, 0))(states, windows)
        if not select:
            return (new_states, new_windows),
        on = states.frame_idx % every == 0
        return _select(on, (new_states, new_windows), (states, windows)),

    keyframe = compile_step(keyframes, name="multistream_keyframe", **kw) if ba else None

    def chunk_step(carry, frames, keys, frame_idx=None):
        draws = draws_of(keys, uniforms, 3)
        S = frames.shape[0]
        if frame_idx is None:
            frame_idx = (carry[0] if ba else carry).frame_idx.tolist()
        elif isinstance(frame_idx, int):
            frame_idx = [frame_idx] * S
        if len(frame_idx) != S:
            raise ValueError(f"frame_idx holds {len(frame_idx)} entries for {S} streams")
        states, windows = carry if ba else (carry, None)
        outs = []
        for j in range(frames.shape[1]):
            states, res = frame(states, frames[:, j], draws[:, j])
            outs.append(res)
            due = [(f + j + 1) % every == 0 for f in frame_idx] if ba else [False]
            if any(due):
                ((states, windows),) = keyframe((states, windows), not all(due))
        stacked = (torch.stack([r.R for r in outs], 1), torch.stack([r.t for r in outs], 1),
                   torch.stack([r.pose_ok for r in outs], 1),
                   torch.stack([r.n_inliers for r in outs], 1))
        return ((states, windows) if ba else states), stacked

    return chunk_step
