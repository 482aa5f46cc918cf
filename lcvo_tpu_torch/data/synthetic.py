"""Synthetic VO sequences with exact ground-truth poses.

The reference validates on KITTI 05 / Malaga / parking image folders
(``src/main.py:14-68``); those datasets are not redistributable, so the framework ships
a physically-consistent synthetic generator: a camera flying through a textured
"corridor" world (ground plane + two side walls + far wall), rendered by per-pixel ray
casting against the planes with an infinite, non-repeating multi-octave value-noise
texture. KLT, E-RANSAC, PnP and triangulation all see realistic parallax, and ATE/RPE
can be asserted against the exact trajectory.

Host-side numpy (image generation is the dataset layer, not the compute path). This is
the PyTorch port's own copy of ``lcvo_tpu/data/synthetic.py``: importing anything under
``lcvo_tpu`` initialises JAX, which the port must not do. The two render the same frames.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _hash2(xi: np.ndarray, yi: np.ndarray, seed: int) -> np.ndarray:
    """Deterministic lattice hash → [0, 1). Vectorized integer mixing (wrapping u64)."""
    with np.errstate(over="ignore"):
        h = (
            xi.astype(np.int64).astype(np.uint64) * np.uint64(374761393)
            + yi.astype(np.int64).astype(np.uint64) * np.uint64(668265263)
            + np.uint64(seed % (1 << 32)) * np.uint64(40503)
        )
        h = h & np.uint64(0xFFFFFFFF)
        h = ((h ^ (h >> np.uint64(13))) * np.uint64(1274126177)) & np.uint64(0xFFFFFFFF)
        h = h ^ (h >> np.uint64(16))
    return (h & np.uint64(0xFFFFFF)).astype(np.float64) / float(0x1000000)


def value_noise(u: np.ndarray, v: np.ndarray, seed: int, octaves: int = 4, base_freq: float = 1.0) -> np.ndarray:
    """Multi-octave bilinear value noise at arbitrary (u, v) world coords → [0, 1]."""
    out = np.zeros_like(u, dtype=np.float64)
    amp_total = 0.0
    for k in range(octaves):
        f = base_freq * (2.0**k)
        amp = 0.6**k
        x = u * f
        y = v * f
        xi = np.floor(x)
        yi = np.floor(y)
        fx = x - xi
        fy = y - yi
        # smoothstep
        sx = fx * fx * (3 - 2 * fx)
        sy = fy * fy * (3 - 2 * fy)
        a = _hash2(xi, yi, seed + k)
        b = _hash2(xi + 1, yi, seed + k)
        c = _hash2(xi, yi + 1, seed + k)
        d = _hash2(xi + 1, yi + 1, seed + k)
        out += amp * ((a * (1 - sx) + b * sx) * (1 - sy) + (c * (1 - sx) + d * sx) * sy)
        amp_total += amp
    return out / amp_total


@dataclass
class CorridorWorld:
    """Axis-aligned corridor: ground y=+ground_y, walls x=±half_width, ceiling off."""

    ground_y: float = 1.6       # camera height above ground (m)
    half_width: float = 6.0     # corridor half width (m)
    end_z: float = 400.0        # far wall distance (never reached)
    seed: int = 7


def make_intrinsics(W: int, H: int, f: float | None = None) -> np.ndarray:
    f = f or 0.58 * W
    return np.array([[f, 0.0, W / 2.0], [0.0, f, H / 2.0], [0.0, 0.0, 1.0]])


def trajectory_forward(n_frames: int, speed: float = 0.35, yaw_amp: float = 0.15, yaw_period: float = 120.0):
    """Smooth forward trajectory with gentle sinusoidal yaw (KITTI-like motion).

    Returns (R_wc (N,3,3), t_wc (N,3)): camera-to-world (position = t_wc). The VO
    convention elsewhere is world→camera; invert as needed.
    """
    Rs, ts = [], []
    pos = np.zeros(3)
    yaw = 0.0
    for i in range(n_frames):
        yaw = yaw_amp * np.sin(2 * np.pi * i / yaw_period)
        c, s = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])  # yaw about y
        fwd = R_wc[:, 2]  # camera z-axis in world
        Rs.append(R_wc)
        ts.append(pos.copy())
        pos = pos + fwd * speed
    return np.stack(Rs), np.stack(ts)


def trajectory_turn(n_frames: int, speed: float = 0.35, turn_start: int = 20,
                    turn_frames: int = 15, turn_deg: float = 60.0):
    """Forward trajectory with one sharp yaw turn (stress case: large per-frame
    rotation, fast appearance change on the walls). ``turn_deg`` total over
    ``turn_frames`` frames (e.g. 60 deg / 15 frames = 4 deg/frame — several times
    KITTI's sharpest corners at this frame rate)."""
    Rs, ts = [], []
    pos = np.zeros(3)
    yaw = 0.0
    rate = np.deg2rad(turn_deg) / max(turn_frames, 1)
    for i in range(n_frames):
        if turn_start <= i < turn_start + turn_frames:
            yaw += rate
        c, s = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        Rs.append(R_wc)
        ts.append(pos.copy())
        pos = pos + R_wc[:, 2] * speed
    return np.stack(Rs), np.stack(ts)


def trajectory_loop(n_frames: int, speed: float = 0.35, straight_frames: int = 260,
                    turn_frames: int = 45, turn_deg: float = 90.0, direction: float = 1.0):
    """Rectangular loop: straight sections joined by sustained constant-rate yaw
    turns (several ~90° corners per lap — the motion profile of the reference's
    KITTI 05 run, whose published trajectory has multiple hard turns,
    ``result-trajectory-plots/kitti_trajectory__sift-sift_0-2759_frames.png``).

    ``turn_deg/turn_frames`` sets the per-frame yaw rate (90°/45 = 2°/frame ≈
    KITTI's sharper corners at 10 fps). Returns (R_wc (N,3,3), t_wc (N,3)).
    """
    Rs, ts = [], []
    pos = np.zeros(3)
    yaw = 0.0
    period = straight_frames + turn_frames
    rate = np.deg2rad(turn_deg) / max(turn_frames, 1) * direction
    for i in range(n_frames):
        if i % period >= straight_frames:
            yaw += rate
        c, s = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        Rs.append(R_wc)
        ts.append(pos.copy())
        pos = pos + R_wc[:, 2] * speed
    return np.stack(Rs), np.stack(ts)


@dataclass
class ArenaWorld:
    """Closed rectangular room: textured ground plane + four walls (ceiling off).
    Generalizes :class:`CorridorWorld` so turn-rich trajectories (loops, 90°
    corners) stay inside textured geometry in every heading."""

    ground_y: float = 1.6
    x_lo: float = -8.0
    x_hi: float = 8.0
    z_lo: float = -8.0
    z_hi: float = 108.0
    seed: int = 7

    @classmethod
    def around(cls, t_wc: np.ndarray, margin: float = 8.0, ground_y: float = 1.6,
               seed: int = 7) -> "ArenaWorld":
        """Smallest arena containing a trajectory with ``margin`` m of clearance
        (walls stay close enough to contribute trackable near-field texture)."""
        return cls(
            ground_y=ground_y,
            x_lo=float(t_wc[:, 0].min() - margin),
            x_hi=float(t_wc[:, 0].max() + margin),
            z_lo=float(t_wc[:, 2].min() - margin),
            z_hi=float(t_wc[:, 2].max() + margin),
            seed=seed,
        )


class SyntheticSequence:
    """Renders frames on demand; exposes the reference dataset-adapter interface
    (K, ground-truth poses, frame count — cf. ``src/main.py:14-68``)."""

    def __init__(
        self,
        n_frames: int = 200,
        width: int = 416,
        height: int = 160,
        world: CorridorWorld | None = None,
        speed: float = 0.35,
        seed: int = 7,
        trajectory: tuple | None = None,
        textureless_span: tuple | None = None,
        occluder: bool = False,
    ):
        """Stress options (VERDICT r1 #5 validation hardening):

        - ``trajectory``: explicit (R_wc (N,3,3), t_wc (N,3)) — e.g.
          :func:`trajectory_turn` for sharp corners.
        - ``textureless_span``: (z0, z1) — the corridor walls are rendered FLAT
          (constant intensity) for wall z in that range: KLT/detection starvation.
        - ``occluder``: a textured 2x1.5 m billboard moving laterally through the
          scene (independent motion violating the static-world assumption).
        """
        self.n_frames = n_frames
        self.W = width
        self.H = height
        self.world = world or CorridorWorld(seed=seed)
        self.K = make_intrinsics(width, height)
        if trajectory is not None:
            self.R_wc, self.t_wc = trajectory
        else:
            self.R_wc, self.t_wc = trajectory_forward(n_frames, speed=speed)
        self.textureless_span = textureless_span
        self.occluder = occluder
        # precompute pixel rays in camera frame
        u, v = np.meshgrid(np.arange(width) + 0.5, np.arange(height) + 0.5)
        Kinv = np.linalg.inv(self.K)
        rays = np.stack([u, v, np.ones_like(u)], axis=-1) @ Kinv.T  # (H, W, 3)
        self._rays = rays

    # --- ground truth in the VO convention (world→camera) ---
    def pose_cw(self, i: int):
        R = self.R_wc[i].T
        t = -R @ self.t_wc[i]
        return R, t

    def gt_positions(self) -> np.ndarray:
        return self.t_wc.copy()

    def frame(self, i: int) -> np.ndarray:
        """Render grayscale frame i as float32 (H, W) in [0, 255]."""
        w = self.world
        R_wc, cam = self.R_wc[i], self.t_wc[i]
        d = self._rays @ R_wc.T  # ray directions in world frame (H, W, 3)
        eps = 1e-9

        def plane_hit(t_hit, mask_extra, u, vv, seed, shade):
            t_hit = np.where((t_hit > 0.1) & mask_extra, t_hit, np.inf)
            tex = value_noise(u, vv, seed, octaves=4, base_freq=1.7) * 0.75 + 0.25
            return t_hit, tex * shade

        hits = []
        texs = []
        # ground: y = ground_y (camera world y=0)
        ty = (w.ground_y - cam[1]) / np.where(np.abs(d[..., 1]) > eps, d[..., 1], eps)
        gx = cam[0] + ty * d[..., 0]
        gz = cam[2] + ty * d[..., 2]
        t_hit, tex = plane_hit(ty, np.abs(gx - cam[0] * 0) < 1e9, gx, gz, w.seed, 1.0)
        hits.append(t_hit)
        texs.append(tex)
        # left wall x = -half_width, right wall x = +half_width
        for sgn, sd in ((-1.0, w.seed + 101), (1.0, w.seed + 202)):
            tx = (sgn * w.half_width - cam[0]) / np.where(np.abs(d[..., 0]) > eps, d[..., 0], eps)
            wy = cam[1] + tx * d[..., 1]
            wz = cam[2] + tx * d[..., 2]
            t_hit, tex = plane_hit(tx, wy < w.ground_y, wz, wy, sd, 0.85)
            if self.textureless_span is not None:
                z0, z1 = self.textureless_span
                tex = np.where((wz >= z0) & (wz < z1), 0.55, tex)
            hits.append(t_hit)
            texs.append(tex)
        # moving occluder: textured billboard at x = x0 + v*i, fixed z, independent
        # motion (breaks the static-world assumption for tracks landing on it)
        if self.occluder:
            z_q = 14.0 + 0.3 * i          # drifts forward slower than the camera
            x_q = -3.0 + 0.12 * i         # sweeps laterally across the corridor
            tq = (z_q - cam[2]) / np.where(np.abs(d[..., 2]) > eps, d[..., 2], eps)
            qx = cam[0] + tq * d[..., 0]
            qy = cam[1] + tq * d[..., 1]
            on_quad = (np.abs(qx - x_q) < 1.0) & (qy > w.ground_y - 2.2) & (qy < w.ground_y - 0.2)
            t_hit, tex = plane_hit(tq, on_quad, qx - x_q + 0.04 * i, qy, w.seed + 404, 0.95)
            hits.append(t_hit)
            texs.append(tex)
        # far wall z = end_z
        tz = (w.end_z - cam[2]) / np.where(np.abs(d[..., 2]) > eps, d[..., 2], eps)
        fx = cam[0] + tz * d[..., 0]
        fy = cam[1] + tz * d[..., 1]
        t_hit, tex = plane_hit(tz, np.ones_like(tz, bool), fx, fy, w.seed + 303, 0.7)
        hits.append(t_hit)
        texs.append(tex)

        hits = np.stack(hits)          # (4, H, W)
        texs = np.stack(texs)
        best = np.argmin(hits, axis=0)
        img = np.take_along_axis(texs, best[None], axis=0)[0]
        # mild depth attenuation for realism
        depth = np.take_along_axis(hits, best[None], axis=0)[0]
        depth = np.where(np.isfinite(depth), depth, w.end_z)
        img = img * (1.0 / (1.0 + 0.002 * depth))
        return (img * 255.0).astype(np.float32)

    def frames(self):
        for i in range(self.n_frames):
            yield self.frame(i)
