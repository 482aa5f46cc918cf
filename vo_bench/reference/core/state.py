"""Fixed-capacity masked VO state (port of ``lcvo_tpu/core/state.py``).

The Markovian state lives in preallocated tables with validity masks:

- ``TrackTable``: landmark tracks P[K,2] pixels, X[K,3] world points, valid[K], plus
  each landmark's anchor (first observation F, frozen pose R_f/t_f, parallax ang)
- ``CandidateTable``: candidate tracks C[M,2], first observation F[M,2], first pose
  (R_f[M,3,3], t_f[M,3]), valid[M], age[M]

Pruning clears masks; insertion assigns new items to free slots by a *stable* argsort
of the validity mask, so the slot order is the JAX package's exactly. Functions are pure
(they return new tables) like the originals.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class TrackTable(NamedTuple):
    P: torch.Tensor      # (K, 2) float32 — pixel positions in the current frame
    X: torch.Tensor      # (K, 3) float32 — world-frame landmarks
    valid: torch.Tensor  # (K,)  bool
    gen: torch.Tensor    # (K,)  int32 — slot generation, bumped on insert
    F: torch.Tensor | None = None     # (K, 2) anchor (first-observation) pixels
    R_f: torch.Tensor | None = None   # (K, 3, 3) anchor world→camera rotation
    t_f: torch.Tensor | None = None   # (K, 3)
    ang: torch.Tensor | None = None   # (K,) parallax angle (rad) at last triangulation

    @property
    def capacity(self) -> int:
        return self.P.shape[0]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid)


class CandidateTable(NamedTuple):
    C: torch.Tensor       # (M, 2) float32 — current pixel positions
    F: torch.Tensor       # (M, 2) float32 — first-observation pixel positions
    R_f: torch.Tensor     # (M, 3, 3) float32 — first-observation world→camera rotation
    t_f: torch.Tensor     # (M, 3) float32
    valid: torch.Tensor   # (M,) bool
    age: torch.Tensor     # (M,) int32 — frames since first observation

    @property
    def capacity(self) -> int:
        return self.C.shape[0]

    def count(self) -> torch.Tensor:
        return torch.sum(self.valid)


class VOState(NamedTuple):
    """Full Markovian per-frame state."""

    tracks: TrackTable
    cands: CandidateTable
    R: torch.Tensor          # (3, 3) current world→camera rotation
    t: torch.Tensor          # (3,) current world→camera translation
    frame_idx: torch.Tensor  # () int32
    prev_image: torch.Tensor  # (H, W) float32 — previous grayscale frame
    prev_pyramid: tuple       # previous frame's pyramid, level 0 = full resolution
    health: torch.Tensor     # () int32 — consecutive inlier-starvation counter
    prev_desc: torch.Tensor | None = None        # (D, 128) float32, sift-sift mode only
    prev_desc_valid: torch.Tensor | None = None  # (D,) bool
    prev_R: torch.Tensor | None = None   # (3, 3) pose before R/t: velocity model
    prev_t: torch.Tensor | None = None   # (3,)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA unless the caller names another; a CUDA
    request on a machine without CUDA raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "lcvo_tpu_torch runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def make_track_table(capacity: int, device="cuda") -> TrackTable:
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return TrackTable(
        P=torch.zeros((capacity, 2), **f32),
        X=torch.zeros((capacity, 3), **f32),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        gen=torch.zeros((capacity,), dtype=torch.int32, device=device),
        F=torch.zeros((capacity, 2), **f32),
        R_f=torch.eye(3, **f32).expand(capacity, 3, 3).clone(),
        t_f=torch.zeros((capacity, 3), **f32),
        # π: refinement triggers on parallax growth, so unseeded slots never refine
        ang=torch.full((capacity,), math.pi, **f32),
    )


def make_candidate_table(capacity: int, device="cuda") -> CandidateTable:
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return CandidateTable(
        C=torch.zeros((capacity, 2), **f32),
        F=torch.zeros((capacity, 2), **f32),
        R_f=torch.zeros((capacity, 3, 3), **f32),
        t_f=torch.zeros((capacity, 3), **f32),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
        age=torch.zeros((capacity,), dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# Masked slot operations
# ---------------------------------------------------------------------------


def _stable_order(mask: torch.Tensor) -> torch.Tensor:
    """Stable argsort of a bool mask: False entries first, each group in index order."""
    return torch.argsort(mask.to(torch.int8), stable=True)


def free_slots(valid: torch.Tensor, n: int) -> torch.Tensor:
    """Indices of the first ``n`` free slots (stable). If fewer than ``n`` are free the
    tail indices point at occupied slots; callers gate on the free count."""
    return _stable_order(valid)[:n]


def _slot_plan(table_valid: torch.Tensor, new_valid: torch.Tensor, capacity: int):
    """(order of new items, n, destination slots, write mask) for a masked insert."""
    order = _stable_order(~new_valid)   # valid new items first, in index order
    n = min(new_valid.shape[0], capacity)
    slots = free_slots(table_valid, n)
    num_free = torch.sum(~table_valid)
    rank = torch.arange(n, device=new_valid.device)
    ok = new_valid[order][:n] & (rank < num_free)
    return order, n, slots, ok


def _put(dst: torch.Tensor, slots: torch.Tensor, ok: torch.Tensor, src) -> torch.Tensor:
    """dst with dst[slots] = where(ok, src, dst[slots]); a new tensor. ``src`` is a
    tensor that broadcasts to dst[slots] or a Python scalar (filled on the device: a
    tensor made from a Python value would be a copy from the host that waits)."""
    cur = dst[slots]
    okb = ok.reshape(ok.shape + (1,) * (cur.dim() - 1))
    if torch.is_tensor(src):
        src = src.to(dst.dtype).expand(cur.shape)
    else:
        src = torch.full_like(cur, src)
    out = dst.clone()
    out[slots] = torch.where(okb, src, cur)
    return out


def insert_into_tracks(table: TrackTable, P_new, X_new, new_valid,
                       F_new=None, R_f_new=None, t_f_new=None, ang_new=None) -> TrackTable:
    """Insert up to N new landmarks into free slots of the track table.

    Only entries with new_valid=True and a genuinely free destination slot are written;
    overflow is dropped. Anchor fields: ``F_new`` (N,2), ``R_f_new`` ((N,3,3) or a
    shared (3,3)), ``t_f_new`` ((N,3) or (3,)), ``ang_new`` (N,) or scalar; omitted,
    inserted tracks anchor at their own position with ``ang=π`` (no refinement).
    """
    order, n, slots, ok = _slot_plan(table.valid, new_valid, table.capacity)
    P_new, X_new = P_new[order][:n], X_new[order][:n]
    out = TrackTable(
        P=_put(table.P, slots, ok, P_new),
        X=_put(table.X, slots, ok, X_new),
        valid=_put(table.valid, slots, ok, True),
        gen=_put(table.gen, slots, ok, table.gen[slots] + 1),
        F=table.F, R_f=table.R_f, t_f=table.t_f, ang=table.ang,
    )
    if table.F is None:
        return out
    if F_new is None:
        F_new = P_new
        R_f_new = torch.eye(3, dtype=torch.float32, device=P_new.device)
        t_f_new = torch.zeros((3,), dtype=torch.float32, device=P_new.device)
        ang_new = math.pi
    else:
        F_new = F_new[order][:n]
        if R_f_new.dim() == 3:
            R_f_new, t_f_new = R_f_new[order][:n], t_f_new[order][:n]
        if torch.is_tensor(ang_new) and ang_new.dim() >= 1:
            ang_new = ang_new[order][:n]
    return out._replace(
        F=_put(table.F, slots, ok, F_new),
        R_f=_put(table.R_f, slots, ok, R_f_new),
        t_f=_put(table.t_f, slots, ok, t_f_new),
        ang=_put(table.ang, slots, ok, ang_new),
    )


def insert_into_candidates(table: CandidateTable, C_new, R_cur, t_cur, new_valid) -> CandidateTable:
    """Admit new candidate keypoints: first observation F=C_new, first pose = current."""
    order, n, slots, ok = _slot_plan(table.valid, new_valid, table.capacity)
    C_new = C_new[order][:n]
    return CandidateTable(
        C=_put(table.C, slots, ok, C_new),
        F=_put(table.F, slots, ok, C_new),
        R_f=_put(table.R_f, slots, ok, R_cur),
        t_f=_put(table.t_f, slots, ok, t_cur),
        valid=_put(table.valid, slots, ok, True),
        age=_put(table.age, slots, ok, 0),
    )


def prune_tracks(table: TrackTable, keep: torch.Tensor) -> TrackTable:
    """Drop tracks where keep=False (index-aligned)."""
    return table._replace(valid=table.valid & keep)


def prune_candidates(table: CandidateTable, keep: torch.Tensor) -> CandidateTable:
    return table._replace(valid=table.valid & keep)


def pyramid_dims(H: int, W: int, levels: int) -> list[tuple[int, int]]:
    """Level sizes: repeated CEIL halvings (``ops.pyramid.downsample2`` emits
    ceil(n/2) rows/cols)."""
    dims = []
    h, w = H, W
    for _ in range(levels):
        dims.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return dims


def make_vo_state(cfg, image_shape, device="cuda") -> VOState:
    """Fresh (pre-bootstrap) state with empty tables."""
    device = resolve_device(device)
    H, W = image_shape
    pyr_dtype = getattr(torch, cfg.runtime.dtype)
    pyr = tuple(torch.zeros(d, dtype=pyr_dtype, device=device)
                for d in pyramid_dims(H, W, cfg.klt.levels))
    f32 = dict(dtype=torch.float32, device=device)
    prev_desc = prev_desc_valid = None
    if cfg.find_new_candidates_method == "sift-sift":
        # previous frame's descriptor table, matched against the new frame's
        D = cfg.descriptor.max_keypoints
        prev_desc = torch.zeros((D, 128), **f32)
        prev_desc_valid = torch.zeros((D,), dtype=torch.bool, device=device)
    return VOState(
        tracks=make_track_table(cfg.state.max_tracks, device),
        cands=make_candidate_table(cfg.state.max_candidates, device),
        R=torch.eye(3, **f32),
        t=torch.zeros((3,), **f32),
        frame_idx=torch.zeros((), dtype=torch.int32, device=device),
        prev_image=torch.zeros((H, W), **f32),
        prev_pyramid=pyr,
        health=torch.zeros((), dtype=torch.int32, device=device),
        prev_desc=prev_desc,
        prev_desc_valid=prev_desc_valid,
        prev_R=torch.eye(3, **f32),
        prev_t=torch.zeros((3,), **f32),
    )


# ---------------------------------------------------------------------------
# Carry a state across from the JAX package
# ---------------------------------------------------------------------------


def _field(tree, name):
    return tree.get(name) if isinstance(tree, dict) else getattr(tree, name)


def _to_tensor(a, device):
    if a is None:
        return None
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def state_from_numpy(tree, device="cuda") -> VOState:
    """Build the port's :class:`VOState` from a JAX ``VOState`` already turned into
    numpy arrays (nested NamedTuples, or dicts keyed by field name, of ``np.ndarray``).

    ``prev_pyramid`` may be a tuple/list of levels or a dict keyed by level index.
    This is how a state carries across from one implementation to the other, the
    ground step-level parity stands on."""
    device = resolve_device(device)
    tr, cd = _field(tree, "tracks"), _field(tree, "cands")
    tracks = TrackTable(*[_to_tensor(_field(tr, f), device) for f in TrackTable._fields])
    cands = CandidateTable(*[_to_tensor(_field(cd, f), device) for f in CandidateTable._fields])
    pyr = _field(tree, "prev_pyramid")
    if isinstance(pyr, dict):
        pyr = [pyr[k] for k in sorted(pyr, key=int)]
    rest = {f: _to_tensor(_field(tree, f), device)
            for f in VOState._fields if f not in ("tracks", "cands", "prev_pyramid")}
    return VOState(tracks=tracks, cands=cands,
                   prev_pyramid=tuple(_to_tensor(p, device) for p in pyr), **rest)


def window_from_numpy(tree, device="cuda"):
    """Build the port's ``KeyframeWindow`` from a JAX ``KeyframeWindow`` already turned
    into numpy arrays (a NamedTuple, or a dict keyed by field name): the BA window's
    counterpart of :func:`state_from_numpy`."""
    from vo_bench.reference.solve.ba.window import KeyframeWindow

    device = resolve_device(device)
    return KeyframeWindow(*[_to_tensor(_field(tree, f), device) for f in KeyframeWindow._fields])
