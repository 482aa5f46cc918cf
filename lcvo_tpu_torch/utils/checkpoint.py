"""Checkpoint / resume of the Markovian VO state (port of
``lcvo_tpu/utils/checkpoint.py``).

The full fixed-shape state (track tables, candidates, pose, pyramid, health, optional
BA window) serializes to one ``.npz`` of path-keyed leaves: long replays resume
mid-sequence, and a crashed run restarts from its last checkpoint.

The file format is the JAX package's: the same keys (``state:.tracks/.P``,
``state:.prev_pyramid/[0]``, ``window:.head``, ``trajectory``, ``frame_idx_host``,
``extra:<name>`` ...), dtypes and shapes, from a walk over the NamedTuples here, and the
PRNG key as ``rng_key`` ((2,) uint32: the port draws from the JAX package's random
stream, ``utils/jax_random.py``), so a checkpoint written by either package resumes in
the other with the same state, window and next draws.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _walk(tree, prefix=""):
    """(key, leaf) of every tensor leaf, keyed as ``jax.tree_util`` keys its paths:
    ``.field`` per NamedTuple field, ``[i]`` per tuple element, joined by ``/``; a
    ``None`` leaf has no key."""
    if tree is None:
        return
    if hasattr(tree, "_fields"):
        items = [(f".{f}", getattr(tree, f)) for f in tree._fields]
    elif isinstance(tree, (tuple, list)):
        items = [(f"[{i}]", v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for name, sub in items:
        yield from _walk(sub, f"{prefix}/{name}" if prefix else name)


def _rebuild(tree, leaves):
    """``tree`` with its tensor leaves replaced, in ``_walk`` order, from the iterator."""
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*[_rebuild(getattr(tree, f), leaves) for f in tree._fields])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves) for v in tree)
    return next(leaves)


def _to_numpy(leaf: torch.Tensor) -> np.ndarray:
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:   # numpy has no bfloat16: keep the bit pattern
        return leaf.view(torch.int16).numpy().view(np.uint16)
    return leaf.numpy()


def _flatten(tree) -> dict:
    return {key: _to_numpy(leaf) for key, leaf in _walk(tree)}


# The leaves a step can make again from the last frame it consumed (``prev_image`` is
# that frame as float32, ``prev_pyramid`` its pyramid): most of a full-width file's
# bytes. ``strip_checkpoint`` leaves them out; ``VisualOdometry.resume(path,
# prev_frame=)`` rebuilds them.
IMAGE_LEAVES = ("state:.prev_image", "state:.prev_pyramid/")
# host-list entries a resumed loop reads back: ``_recent_step_scale`` takes the median of
# the last 16 steps, 17 camera centers
HOST_HISTORY = 17


def save_checkpoint(path: str, state, window=None, trajectory=None,
                    frame_idx: int | None = None, rng_key=None, poses=None,
                    pose_ok_flags=None, extras: dict | None = None):
    """Serialize VO state (+ optional BA window, host-side trajectory and full 4x4
    poses, and the PRNG key the next RANSAC samples are drawn from, needed for bit-exact
    resume) to npz. ``extras``: small host-side scalars (e.g. the recovery counter)
    stored as ``extra:<name>`` keys."""
    payload = {f"state:{k}": v for k, v in _flatten(state).items()}
    for k, v in (extras or {}).items():
        payload[f"extra:{k}"] = np.asarray(v)
    if window is not None:
        payload.update({f"window:{k}": v for k, v in _flatten(window).items()})
    if trajectory is not None and len(trajectory):
        payload["trajectory"] = np.asarray(trajectory)
    if poses is not None and len(poses):
        payload["poses"] = np.asarray(poses)
    if pose_ok_flags is not None and len(pose_ok_flags):
        payload["pose_ok_flags"] = np.asarray(pose_ok_flags, bool)
    if frame_idx is not None:
        payload["frame_idx_host"] = np.asarray(frame_idx)
    if rng_key is not None:
        payload["rng_key"] = np.asarray(rng_key, dtype=np.uint32)
    # ATOMIC write: a kill mid-write must never leave a truncated archive at the
    # checkpoint path. Write to a temp file in the same directory, fsync, then rename:
    # os.replace is atomic on POSIX, so the path always holds either the old or the new
    # complete checkpoint.
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **payload)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_checkpoint(path: str, state_template, window_template=None):
    """Restore ``(state, window, trajectory, frame_idx, rng, poses, flags, extras)``
    from npz.

    Templates supply the STRUCTURE, the device and the dtypes (e.g.
    ``make_vo_state(cfg, shape, device)``); leaves are filled from the file and must
    match the template's shapes and dtypes exactly. ``rng`` is the PRNG key, (2,)
    uint32, or ``None`` for a file without one. A file may lack the
    :data:`IMAGE_LEAVES`, which then keep the template's value (the caller rebuilds
    them); any other missing leaf raises ``KeyError``."""
    data = np.load(path, allow_pickle=False)

    def restore(tree, prefix):
        leaves = []
        for key, leaf in _walk(tree):
            key = prefix + key
            if key not in data.files and key.startswith(IMAGE_LEAVES):
                leaves.append(leaf)
                continue
            arr = data[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {key}: shape {arr.shape} != template "
                                 f"{tuple(leaf.shape)}")
            if leaf.dtype == torch.bfloat16 and arr.dtype == np.uint16:
                new = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                new = torch.from_numpy(np.array(arr, copy=True))
            if new.dtype != leaf.dtype:
                raise ValueError(f"checkpoint leaf {key}: dtype {arr.dtype} != template "
                                 f"{leaf.dtype}")
            leaves.append(new.to(leaf.device))
        return _rebuild(tree, iter(leaves))

    state = restore(state_template, "state:")
    window = restore(window_template, "window:") if window_template is not None else None
    trajectory = [p for p in data["trajectory"]] if "trajectory" in data else []
    frame_idx = int(data["frame_idx_host"]) if "frame_idx_host" in data else None
    rng = np.array(data["rng_key"], dtype=np.uint32) if "rng_key" in data else None
    poses = [p for p in data["poses"]] if "poses" in data else None
    flags = [bool(f) for f in data["pose_ok_flags"]] if "pose_ok_flags" in data else None
    extras = {k[len("extra:"):]: data[k] for k in data.files if k.startswith("extra:")}
    return state, window, trajectory, frame_idx, rng, poses, flags, extras


def has_image_leaves(path: str) -> bool:
    with np.load(path, allow_pickle=False) as data:
        return IMAGE_LEAVES[0] in data.files


def strip_checkpoint(src: str, dst: str) -> None:
    """Write ``src`` to ``dst`` without its image leaves and with its host lists
    (trajectory, poses, pose_ok flags) cut to their last :data:`HOST_HISTORY` entries:
    what a resumed run reads. A run resumed from ``dst`` numbers its trajectory entries
    from there."""
    with np.load(src, allow_pickle=False) as data:
        payload = {k: data[k] for k in data.files if not k.startswith(IMAGE_LEAVES)}
    for k in ("trajectory", "poses", "pose_ok_flags"):
        if k in payload:
            payload[k] = payload[k][-HOST_HISTORY:]
    tmp = dst + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **payload)
    os.replace(tmp, dst)
