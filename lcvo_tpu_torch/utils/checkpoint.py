"""Checkpoint / resume of the Markovian VO state (port of
``lcvo_tpu/utils/checkpoint.py``).

The full fixed-shape state (track tables, candidates, pose, pyramid, health, optional
BA window) serializes to one ``.npz`` of path-keyed leaves: long replays resume
mid-sequence, and a crashed run restarts from its last checkpoint.

The file format is the JAX package's: the same keys (``state:.tracks/.P``,
``state:.prev_pyramid/[0]``, ``window:.head``, ``trajectory``, ``frame_idx_host``,
``extra:<name>`` ...), dtypes and shapes, from a walk over the NamedTuples here, so a
checkpoint written by either package restores the state and the window in the other.
The random stream is the exception: the JAX package stores its PRNG key as ``rng_key``;
this one stores the ``torch.Generator`` state as ``torch_rng_state`` with the
generator's device type beside it (``torch_rng_device``), and ignores ``rng_key``.
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


def save_checkpoint(path: str, state, window=None, trajectory=None,
                    frame_idx: int | None = None, generator: torch.Generator | None = None,
                    poses=None, pose_ok_flags=None, extras: dict | None = None):
    """Serialize VO state (+ optional BA window, host-side trajectory and full 4x4
    poses, and the generator the RANSAC samples are drawn from, needed for bit-exact
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
    if generator is not None:
        payload["torch_rng_state"] = generator.get_state().numpy()
        payload["torch_rng_device"] = np.asarray(generator.device.type)
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
    match the template's shapes and dtypes exactly. ``rng`` is ``(generator state as a
    uint8 tensor, device type it was saved on)``, or ``None`` for a file without one
    (a checkpoint of the JAX package)."""
    data = np.load(path, allow_pickle=False)

    def restore(tree, prefix):
        leaves = []
        for key, leaf in _walk(tree):
            key = prefix + key
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
    rng = None
    if "torch_rng_state" in data:
        rng = (torch.from_numpy(np.array(data["torch_rng_state"], copy=True)),
               str(data["torch_rng_device"]))
    poses = [p for p in data["poses"]] if "poses" in data else None
    flags = [bool(f) for f in data["pose_ok_flags"]] if "pose_ok_flags" in data else None
    extras = {k[len("extra:"):]: data[k] for k in data.files if k.startswith("extra:")}
    return state, window, trajectory, frame_idx, rng, poses, flags, extras
