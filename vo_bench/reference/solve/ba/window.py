"""Keyframe window manager for sliding-window BA (port of
``lcvo_tpu/solve/ba/window.py``).

Bridges the Markovian per-frame state (which keeps no history) and the BA window (the
one component that does). A ring buffer of the last ``W`` keyframes stores, per
keyframe: the pose and a snapshot of the track table's pixel observations + slot
generations. Landmark identity across keyframes is slot index + generation: a slot that
was pruned and re-used for a different landmark gets a bumped ``gen`` (see
:class:`vo_bench.reference.core.state.TrackTable`), so stale observations are masked out
instead of corrupting the window.

All window ops are fixed-shape, return new tensors and read nothing back to the host:
the ring position ``head`` stays a 0-d tensor on the device and is never turned into a
Python int.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vo_bench.reference.core import geometry as geo
from vo_bench.reference.core.state import TrackTable, resolve_device
from vo_bench.reference.solve.ba.schur import BAProblem, ba_solve


class KeyframeWindow(NamedTuple):
    """Ring buffer of W keyframes over a K-slot track table."""

    R: torch.Tensor          # (W, 3, 3) world→camera pose at each keyframe
    t: torch.Tensor          # (W, 3)
    obs: torch.Tensor        # (W, K, 2) pixel observations of track slot k
    obs_gen: torch.Tensor    # (W, K) int32 — track generation when observed
    obs_valid: torch.Tensor  # (W, K) bool
    kf_valid: torch.Tensor   # (W,) bool — slot holds a real keyframe
    head: torch.Tensor       # () int32 — ring position of the NEXT write


def make_window(window: int, capacity: int, device="cuda") -> KeyframeWindow:
    device = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=device)
    return KeyframeWindow(
        R=torch.eye(3, **f32).expand(window, 3, 3).clone(),
        t=torch.zeros((window, 3), **f32),
        obs=torch.zeros((window, capacity, 2), **f32),
        obs_gen=torch.full((window, capacity), -1, dtype=torch.int32, device=device),
        obs_valid=torch.zeros((window, capacity), dtype=torch.bool, device=device),
        kf_valid=torch.zeros((window,), dtype=torch.bool, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
    )


def push(win: KeyframeWindow, tracks: TrackTable, R, t) -> KeyframeWindow:
    """Record the current frame as a keyframe (overwrites the oldest)."""
    W = win.R.shape[0]
    at = torch.arange(W, device=win.head.device) == win.head  # one-hot of the write slot

    def put(dst, src):
        sel = at.reshape((W,) + (1,) * (dst.dim() - 1))
        return torch.where(sel, src.to(dst.dtype), dst)

    return KeyframeWindow(
        R=put(win.R, R),
        t=put(win.t, t),
        obs=put(win.obs, tracks.P),
        obs_gen=put(win.obs_gen, tracks.gen),
        obs_valid=put(win.obs_valid, tracks.valid),
        kf_valid=win.kf_valid | at,
        head=(win.head + 1) % W,
    )


def _chronological_order(win: KeyframeWindow):
    """Ring indices oldest→newest (the head points at the oldest slot)."""
    W = win.R.shape[0]
    return (win.head + torch.arange(W, device=win.head.device)) % W


def gather_problem(win: KeyframeWindow, tracks: TrackTable, K_mat) -> tuple[BAProblem, torch.Tensor]:
    """Build a dense-grid BAProblem from the window + current track table.

    Observations are valid iff the keyframe is real, the observation was valid when
    recorded, the track slot is still alive, and the generation matches (same
    landmark). Landmarks observed by < 2 keyframes are masked entirely (nothing to
    adjust). Returns (problem, order) where order maps problem row w → ring slot.
    ``K_mat``: the intrinsics, a tensor on the window's device (an array is copied
    there, which waits for the device).
    """
    order = _chronological_order(win)
    R = win.R[order]
    t = win.t[order]
    obs_px = win.obs[order]
    m = (
        win.obs_valid[order]
        & win.kf_valid[order][:, None]
        & tracks.valid[None, :]
        & (win.obs_gen[order] == tracks.gen[None, :])
    )
    n_views = torch.sum(m, dim=0)
    m = m & (n_views[None, :] >= 2)
    if not torch.is_tensor(K_mat):
        K_mat = torch.as_tensor(np.asarray(K_mat, np.float32), device=obs_px.device)
    obs_n = geo.normalize_points(obs_px.reshape(-1, 2), K_mat).reshape(obs_px.shape)
    return BAProblem(R=R, t=t, X=tracks.X, obs=obs_n, mask=m), order


def refine_window(
    win: KeyframeWindow,
    tracks: TrackTable,
    K_mat,
    iters: int = 5,
    n_fix: int = 2,
    huber: float = 3e-3,
    lam0: float = 1e-4,
    landmarks_only: bool = False,
    gauge: str = "oldest",
):
    """Run window BA and write the results back.

    Returns (win', tracks', R_latest, t_latest, result). Landmark updates are applied
    only to slots that actually participated (≥ 2 valid views); pose updates are
    written back into the ring. The newest keyframe's refined pose is returned so the
    caller can re-anchor the live pose.
    """
    problem, order = gather_problem(win, tracks, K_mat)
    # gauge anchor: freeze n_fix REAL keyframes. Before the ring fills (and right after
    # a re-bootstrap reset) the chronological order leads with EMPTY slots: freezing
    # those instead of real poses leaves the window's gauge (incl. monocular scale)
    # floating on LM damping alone, which injects scale drift every refine (ba_solve
    # docstring). With ≤ n_fix real keyframes this freezes them ALL: landmark-only
    # refinement.
    #
    # gauge='oldest' (classic) vs 'newest' (backward smoothing: the live pose never
    # jumps and the window adopts the CURRENT scale instead of dragging the newest
    # pose toward the oldest keyframe's scale, see BAConfig.gauge).
    kfv = win.kf_valid[order]
    if landmarks_only:
        # structure-only refinement: ALL real keyframe poses frozen, multi-view depth
        # correction without pose feedback (no gauge motion possible)
        fix_rows = torch.ones_like(kfv)
    elif gauge == "newest":
        rev_rank = torch.flip(torch.cumsum(torch.flip(kfv, [0]).to(torch.int32), 0), [0])
        fix_rows = kfv & (rev_rank <= n_fix)  # rank 1 = newest real keyframe
    else:
        fix_rows = kfv & (torch.cumsum(kfv.to(torch.int32), 0) <= n_fix)
    res = ba_solve(problem, iters=iters, n_fix=n_fix, huber=huber, lam0=lam0,
                   fix_rows=fix_rows)

    adjusted = torch.sum(problem.mask, dim=0) >= 2  # (K,)
    tracks = tracks._replace(X=torch.where(adjusted[:, None], res.X, tracks.X))
    if tracks.ang is not None:
        # a multi-view-refined landmark outranks 2-view anchor re-triangulation:
        # retire the anchor (ang=π disables further refinement for the slot) so the
        # pipeline's anchor pass can't overwrite BA's estimate
        tracks = tracks._replace(ang=torch.where(adjusted, math.pi, tracks.ang))

    # ``order`` is a permutation of the ring slots: row w of the result goes back to
    # slot order[w], and the newest keyframe is the last row
    win = win._replace(R=win.R.index_copy(0, order, res.R),
                       t=win.t.index_copy(0, order, res.t))
    return win, tracks, res.R[-1], res.t[-1], res
