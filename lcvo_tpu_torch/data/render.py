"""Corridor and arena renderers in PyTorch — fast synthetic-sequence generation.

Port of ``lcvo_tpu/data/render_jax.py`` (the file name drops ``_jax``; the functions keep
their names). ``data/synthetic.py`` renders on the host in numpy, about a second per
frame at KITTI resolution: fine for short test fixtures, not for full-length replays.
This module renders the SAME worlds as plain elementwise tensor code on the device, for
generating on-disk replay datasets (``tools/port_make_replay_dataset.py``). The
reference computes this as one jitted elementwise program outside any hand-written
kernel, so plain tensor code is its counterpart.

The integer lattice hash equals ``synthetic._hash2`` bit for bit: PyTorch has next to no
arithmetic on ``uint32`` and ``>>`` on ``int32`` is arithmetic, so the hash is computed
in ``int64`` and masked to 32 bits after every product and sum. Interpolation runs in f32
rather than the numpy fixture's f64, a sub-1% intensity difference that leaves the
dataset fully self-consistent with its exact ground-truth poses.

Every function takes one pose (``R_wc`` (3, 3), ``cam`` (3,)) or a batch of them
((B, 3, 3), (B, 3)) and returns (H, W) or (B, H, W) uint8: a frame is about a hundred
small elementwise ops, so rendering a batch per call is what keeps a device busy.
3-vector products are written out as elementwise sums, so a frame does not depend on a
library's matmul and the same pose gives the same pixels in a batch of any size.
"""

from __future__ import annotations

import numpy as np
import torch

from lcvo_tpu_torch.core.state import resolve_device
from lcvo_tpu_torch.data.synthetic import CorridorWorld

_M32 = 0xFFFFFFFF


def _hash2(xi: torch.Tensor, yi: torch.Tensor, seed: int) -> torch.Tensor:
    """Lattice hash → [0, 1) in f32; bit-exact vs ``synthetic._hash2`` (uint32 wrap-around
    emulated in int64: every intermediate stays below 2**63, negative lattice indices
    wrap as a cast to uint32 would)."""
    x = xi.to(torch.int64) & _M32
    y = yi.to(torch.int64) & _M32
    h = ((x * 374761393) & _M32) + ((y * 668265263) & _M32) + ((seed % (1 << 32)) * 40503 & _M32)
    h = h & _M32
    h = ((h ^ (h >> 13)) * 1274126177) & _M32
    h = h ^ (h >> 16)
    return (h & 0xFFFFFF).to(torch.float32) / float(0x1000000)


def _value_noise(u: torch.Tensor, v: torch.Tensor, seed: int, octaves: int = 4,
                 base_freq: float = 1.0) -> torch.Tensor:
    out = torch.zeros_like(u)
    amp_total = 0.0
    for k in range(octaves):
        # Python numbers, not f64 tensors: an f32 tensor times a Python float stays f32
        f = base_freq * (2.0 ** k)
        amp = 0.6 ** k
        x = u * f
        y = v * f
        xi = torch.floor(x)
        yi = torch.floor(y)
        fx = x - xi
        fy = y - yi
        sx = fx * fx * (3 - 2 * fx)
        sy = fy * fy * (3 - 2 * fy)
        xi = xi.to(torch.int32)
        yi = yi.to(torch.int32)
        a = _hash2(xi, yi, seed + k)
        b = _hash2(xi + 1, yi, seed + k)
        c = _hash2(xi, yi + 1, seed + k)
        d = _hash2(xi + 1, yi + 1, seed + k)
        out = out + amp * ((a * (1 - sx) + b * sx) * (1 - sy) + (c * (1 - sx) + d * sx) * sy)
        amp_total += amp
    return out / amp_total


def _rays(R_wc: torch.Tensor, Kinv: torch.Tensor, H: int, W: int):
    """World-frame ray directions through the pixel centres: three (B, H, W) tensors.
    ``R_wc`` is (B, 3, 3)."""
    dev = R_wc.device
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev) + 0.5,
                          torch.arange(W, dtype=torch.float32, device=dev) + 0.5,
                          indexing="ij")
    # camera-frame rays  [u, v, 1] @ Kinv.T
    r = [u * Kinv[c, 0] + v * Kinv[c, 1] + Kinv[c, 2] for c in range(3)]
    R = R_wc[:, :, :, None, None]           # (B, 3, 3, 1, 1)
    return [r[0] * R[:, c, 0] + r[1] * R[:, c, 1] + r[2] * R[:, c, 2] for c in range(3)]


def _plane_hit(t_hit, mask_extra, uu, vv, sd: int, shade: float):
    ok = t_hit > 0.1
    if mask_extra is not None:
        ok = ok & mask_extra
    t_hit = torch.where(ok, t_hit, torch.full_like(t_hit, float("inf")))
    tex = _value_noise(uu, vv, sd, octaves=4, base_freq=1.7) * 0.75 + 0.25
    return t_hit, tex * shade


def _nonzero(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    return torch.where(torch.abs(x) > eps, x, torch.full_like(x, eps))


def _shade_nearest(hits: list, texs: list, far: float) -> torch.Tensor:
    """Texture of the nearest hit (ties go to the first plane), attenuated by depth."""
    hits = torch.stack(hits)
    texs = torch.stack(texs)
    best = torch.argmin(hits, dim=0, keepdim=True)
    img = torch.gather(texs, 0, best)[0]
    depth = torch.gather(hits, 0, best)[0]
    depth = torch.where(torch.isfinite(depth), depth, torch.full_like(depth, far))
    img = img * (1.0 / (1.0 + 0.002 * depth))
    # .to(uint8) of a non-negative float truncates, as the reference's cast does
    return torch.clamp(img * 255.0, 0, 255).to(torch.uint8)


def _batched(R_wc: torch.Tensor, cam: torch.Tensor):
    single = R_wc.dim() == 2
    if single:
        R_wc, cam = R_wc[None], cam[None]
    return single, R_wc.to(torch.float32), cam.to(torch.float32)[:, :, None, None]


def _ground_and_x_walls(d, cam, ground_y: float, x_walls, seed: int):
    """Hits of the ground plane and of two walls of constant x (both worlds share them)."""
    hits, texs = [], []
    ty = (ground_y - cam[:, 1]) / _nonzero(d[1])
    gx = cam[:, 0] + ty * d[0]
    gz = cam[:, 2] + ty * d[2]
    t_hit, tex = _plane_hit(ty, None, gx, gz, seed, 1.0)
    hits.append(t_hit)
    texs.append(tex)
    dx = _nonzero(d[0])
    for wall_x, sd in zip(x_walls, (seed + 101, seed + 202)):
        tx = (wall_x - cam[:, 0]) / dx
        wy = cam[:, 1] + tx * d[1]
        wz = cam[:, 2] + tx * d[2]
        t_hit, tex = _plane_hit(tx, wy < ground_y, wz, wy, sd, 0.85)
        hits.append(t_hit)
        texs.append(tex)
    return hits, texs


@torch.no_grad()
def render_frame(R_wc, cam, Kinv, H: int, W: int, ground_y: float = 1.6,
                 half_width: float = 6.0, end_z: float = 400.0, seed: int = 7) -> torch.Tensor:
    """Render (H, W) grayscale frame(s) of the corridor world, uint8.

    Same geometry/texture as ``synthetic.SyntheticSequence.frame`` (ground plane,
    two walls, far wall, multi-octave value noise, depth attenuation).
    """
    single, R_wc, cam = _batched(R_wc, cam)
    d = _rays(R_wc, Kinv, H, W)
    hits, texs = _ground_and_x_walls(d, cam, ground_y, (-1.0 * half_width, 1.0 * half_width), seed)
    tz = (end_z - cam[:, 2]) / _nonzero(d[2])
    fx = cam[:, 0] + tz * d[0]
    fy = cam[:, 1] + tz * d[1]
    t_hit, tex = _plane_hit(tz, None, fx, fy, seed + 303, 0.7)
    hits.append(t_hit)
    texs.append(tex)
    img = _shade_nearest(hits, texs, end_z)
    return img[0] if single else img


@torch.no_grad()
def render_frame_arena(R_wc, cam, Kinv, H: int, W: int, ground_y: float,
                       x_lo: float, x_hi: float, z_lo: float, z_hi: float,
                       seed: int = 7, occ=None) -> torch.Tensor:
    """Render uint8 frame(s) of an :class:`~lcvo_tpu_torch.data.synthetic.ArenaWorld`:
    ground plane + four axis-aligned walls. The closed room means every ray hits
    textured geometry in any heading — required for loop trajectories with
    sustained 90° turns (the corridor's open ends would show void mid-turn).
    Same lattice-hash texture and depth attenuation as :func:`render_frame`.

    ``occ``: optional independently-moving textured billboard (static-world
    violation, the arena analog of ``synthetic.SyntheticSequence(occluder=True)``):
    a dict of tensors ``{"q": (3,) center, "right": (3,), "up": (3,),
    "normal": (3,), "uoff": ()}``, each with a leading batch dimension where the poses
    have one — a 2x1.5 m quad at ``q`` spanned by right/up, texture drifting by
    ``uoff`` (so tracks on it see independent motion and must be rejected by RANSAC)."""
    single, R_wc, cam = _batched(R_wc, cam)
    d = _rays(R_wc, Kinv, H, W)
    hits, texs = _ground_and_x_walls(d, cam, ground_y, (x_lo, x_hi), seed)
    dz = _nonzero(d[2])
    for wall_z, sd in ((z_lo, seed + 303), (z_hi, seed + 404)):
        tz = (wall_z - cam[:, 2]) / dz
        wx = cam[:, 0] + tz * d[0]
        wy = cam[:, 1] + tz * d[1]
        t_hit, tex = _plane_hit(tz, wy < ground_y, wx, wy, sd, 0.78)
        hits.append(t_hit)
        texs.append(tex)

    if occ is not None:
        vec = lambda name: (occ[name][None] if single else occ[name]).to(torch.float32)[:, :, None, None]
        q, rt, up, nq = vec("q"), vec("right"), vec("up"), vec("normal")
        uoff = (occ["uoff"].reshape(1) if single else occ["uoff"]).to(torch.float32)[:, None, None]
        dot = lambda a, b: a[0] * b[:, 0] + a[1] * b[:, 1] + a[2] * b[:, 2]
        dn = _nonzero(dot(d, nq))
        qc = q - cam
        tq = (qc[:, 0] * nq[:, 0] + qc[:, 1] * nq[:, 1] + qc[:, 2] * nq[:, 2]) / dn
        rel = [cam[:, c] + tq * d[c] - q[:, c] for c in range(3)]
        hu = dot(rel, rt)
        hv = dot(rel, up)
        on_quad = (torch.abs(hu) < 1.0) & (hv > -0.75) & (hv < 0.75)
        t_hit, tex = _plane_hit(tq, on_quad, hu + uoff, hv, seed + 505, 0.95)
        hits.append(t_hit)
        texs.append(tex)

    img = _shade_nearest(hits, texs, 1e4)
    return img[0] if single else img


class _FastRenderer:
    """What the two renderers share: a (R_wc, t_wc) trajectory with exact host-side
    ground truth, frames rendered on ``device`` one at a time or a batch per call."""

    def _setup(self, R_wc, t_wc, width: int, height: int, K, device):
        from lcvo_tpu_torch.data.synthetic import make_intrinsics

        self.device = resolve_device(device)
        self.R_wc, self.t_wc = R_wc, t_wc
        self.n_frames = len(R_wc)
        self.W, self.H = width, height
        self.K = make_intrinsics(width, height) if K is None else np.asarray(K, np.float64)
        self._Kinv = self._f32(np.linalg.inv(self.K))

    def _f32(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def _render(self, idx) -> torch.Tensor:
        raise NotImplementedError

    def frames_device(self, start: int, stop: int) -> torch.Tensor:
        """(stop - start, H, W) uint8 on the renderer's device, one batched render."""
        return self._render(np.arange(start, stop))

    def frame(self, i: int) -> np.ndarray:
        return self._render(np.array([i]))[0].cpu().numpy()

    def gt_pose_rows(self) -> np.ndarray:
        """(N, 12) KITTI pose-file rows: flattened cam→world [R|t]."""
        P = np.concatenate([self.R_wc, self.t_wc[:, :, None]], axis=2)
        return P.reshape(self.n_frames, 12)

    def gt_positions(self) -> np.ndarray:
        """(N, 3) camera positions in world frame (same API as SyntheticSequence)."""
        return self.t_wc.copy()


class FastArenaRenderer(_FastRenderer):
    """Device-rendered arena sequence over an arbitrary trajectory, with exact
    host-side ground truth. The turn-rich counterpart of
    :class:`FastCorridorRenderer` — pass a (R_wc, t_wc) trajectory (e.g.
    ``synthetic.trajectory_loop``); the arena auto-sizes around it."""

    def __init__(self, trajectory: tuple, width: int, height: int,
                 K: np.ndarray | None = None, margin: float = 8.0, seed: int = 7,
                 occluder: bool = False, device="cuda"):
        from lcvo_tpu_torch.data.synthetic import ArenaWorld

        self._setup(trajectory[0], trajectory[1], width, height, K, device)
        self.world = ArenaWorld.around(self.t_wc, margin=margin, seed=seed)
        self.occluder = occluder

    def _occ_np(self, i: int) -> dict:
        """Billboard 12 m ahead along the current heading, sweeping laterally
        (independent motion) with drifting texture — always in view regardless
        of where the loop trajectory points."""
        R, cam = self.R_wc[i], self.t_wc[i]
        fwd, right = R[:, 2], R[:, 0]
        up = np.array([0.0, -1.0, 0.0])
        x_q = -3.0 + 0.12 * (i % 50)
        q = cam + fwd * 12.0 + right * x_q + np.array([0.0, -0.4, 0.0])
        return {"q": q, "right": right, "up": up, "normal": fwd, "uoff": 0.04 * i}

    def _occ(self, idx) -> dict:
        rows = [self._occ_np(int(i)) for i in idx]
        return {k: self._f32(np.stack([r[k] for r in rows])) for k in rows[0]}

    def _render(self, idx) -> torch.Tensor:
        w = self.world
        return render_frame_arena(
            self._f32(self.R_wc[idx]), self._f32(self.t_wc[idx]), self._Kinv, self.H, self.W,
            ground_y=w.ground_y, x_lo=w.x_lo, x_hi=w.x_hi, z_lo=w.z_lo, z_hi=w.z_hi,
            seed=w.seed, occ=self._occ(idx) if self.occluder else None,
        )


class FastCorridorRenderer(_FastRenderer):
    """Device-rendered corridor sequence with exact host-side ground truth."""

    def __init__(self, n_frames: int, width: int, height: int, speed: float = 0.35,
                 world: CorridorWorld | None = None, K: np.ndarray | None = None,
                 device="cuda"):
        from lcvo_tpu_torch.data.synthetic import trajectory_forward

        R_wc, t_wc = trajectory_forward(n_frames, speed=speed)
        self._setup(R_wc, t_wc, width, height, K, device)
        # push the far wall beyond the full trajectory (the short-fixture default
        # of 400 m would be reached after ~1,100 frames at 0.35 m/frame)
        far = max(400.0, n_frames * speed + 500.0)
        self.world = world or CorridorWorld(end_z=far)

    def _render(self, idx) -> torch.Tensor:
        w = self.world
        return render_frame(
            self._f32(self.R_wc[idx]), self._f32(self.t_wc[idx]), self._Kinv, self.H, self.W,
            ground_y=w.ground_y, half_width=w.half_width, end_z=w.end_z, seed=w.seed,
        )
