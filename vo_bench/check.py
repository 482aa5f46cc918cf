"""How a run decides ``correct``: the plain reference (``vo_bench/reference``, a frozen
copy of the port's eager code, with the plain block extraction and ``torch.linalg.svd``)
follows the program step by step from the program's own state.

During the window the harness clones the host loop's state (and BA window) at sampled
chunk or frame boundaries, and every bootstrap's state. After the window the reference
takes each cloned state, works out the draws of the JAX key schedule from the seed
itself, runs the next frames the program ran (the per-frame step and, on the BA cadence,
the keyframe step) or the bootstrap on the same frames, and the poses are compared:

    gap = |c_program - c_reference| / max(|c_reference - c_start|, 1e-3)

per frame, with ``c`` a camera center and ``c_start`` the center the compared stretch
starts from (the cloned state's, or the first bootstrap camera's). A frame whose pose
is not finite on one side only reads ``inf``. ``pose_gap`` is the largest gap over the
compared frames.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import numpy as np
import torch

from vo_bench.reference import pipeline as ref_pipeline
from vo_bench.reference.core import state as ref_state
from vo_bench.reference.solve.ba import window as ref_window
from vo_bench.reference.utils import jax_random

_REF_TYPES = {"VOState": ref_state.VOState, "TrackTable": ref_state.TrackTable,
              "CandidateTable": ref_state.CandidateTable,
              "KeyframeWindow": ref_window.KeyframeWindow}


def clone_tree(x):
    """A deep copy of a state tree (named tuples, tuples, tensors, None) on its device."""
    if x is None:
        return None
    if torch.is_tensor(x):
        return x.detach().clone()
    if hasattr(x, "_fields"):
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, tuple):
        return tuple(clone_tree(v) for v in x)
    raise TypeError(f"cannot clone a {type(x).__name__} of a state")


def to_reference(x):
    """A cloned program state tree as the reference's own types, field by field."""
    if x is None or torch.is_tensor(x):
        return x
    if hasattr(x, "_fields"):
        cls = _REF_TYPES[type(x).__name__]
        return cls(**{f: to_reference(getattr(x, f)) for f in x._fields})
    return tuple(to_reference(v) for v in x)


class KeyChain:
    """The JAX package's key chain of one host loop: ``PRNGKey(seed)`` split once per
    bootstrap, per step and per chunk. ``key(i)`` is the key the i-th split (1-based)
    hands out."""

    def __init__(self, seed: int):
        self._chain = jax_random.PRNGKey(seed)
        self._keys: list = []

    def key(self, i: int) -> np.ndarray:
        while len(self._keys) < i:
            self._chain, k = jax_random.split(self._chain)
            self._keys.append(k)
        return self._keys[i - 1]


@dataclass
class Sample:
    """One compared stretch: the program's state before it, how the draws are keyed,
    and the program's poses of its frames.

    ``kind``: "steps" (from ``state``/``window`` at host mirror ``frame_idx``, frames
    ``frames[first:first + n]``; ``keys`` the chain index of each step's key, or one
    chunk key index with ``chunk`` set) or "bootstrap" (``frames[first:first + gap + 1]``
    under the key ``keys[0]``, anchored at the origin). ``end``: the program's state and
    window after a full stretch of steps (None where a bootstrap cut it)."""

    kind: str
    first: int
    keys: list
    state: object = None
    window: object = None
    frame_idx: int = 0
    chunk: int = 0
    poses: list = field(default_factory=list)     # [(R (3,3), t (3,), pose_ok)]
    end: tuple | None = None


def center(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return -np.asarray(R, np.float64).T @ np.asarray(t, np.float64)


def _rel_gap(prog: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> float:
    """max over rows of |prog - ref| / scale (rows (n, 3), scale (n,)); a row not finite
    on one side only reads inf, on both sides 0."""
    if ref.shape[0] == 0:
        return 0.0
    prog, ref, scale = prog.double(), ref.double(), scale.double().clamp_min(1e-3)
    fin_p, fin_r = torch.isfinite(prog).all(1), torch.isfinite(ref).all(1)
    if bool((fin_p != fin_r).any()):
        return float("inf")
    both = fin_p & fin_r & torch.isfinite(scale)
    if not bool(both.any()):
        return 0.0
    return float(((prog - ref).norm(dim=1)[both] / scale[both]).max())


def map_gap(prog: tuple, ref: tuple) -> float:
    """How far the program's map after a stretch of steps lies from the reference's,
    each ``(state, window)``: the landmarks of the track slots live on both sides in the
    same generation (each gap over the landmark's distance from the reference's camera)
    and, with BA, the keyframes' camera centers (each gap over the window's extent). A
    keyframe slot filled on one side only reads inf."""
    (sp, wp), (sr, wr) = prog, ref
    tp, tr = sp.tracks, sr.tracks
    cam = -(sr.R.double().T @ sr.t.double())
    v = tp.valid & tr.valid & (tp.gen == tr.gen)
    gap = _rel_gap(tp.X[v], tr.X[v], (tr.X[v].double() - cam).norm(dim=1))
    if wr is not None:
        if not torch.equal(wp.kf_valid, wr.kf_valid):
            return float("inf")
        k = wr.kf_valid

        def centers(w):
            return -(w.R[k].double().transpose(1, 2) @ w.t[k].double()[..., None])[..., 0]

        cp, cr = centers(wp), centers(wr)
        extent = (cr[:, None] - cr[None]).norm(dim=-1).max() if k.any() else torch.tensor(1.0)
        gap = max(gap, _rel_gap(cp, cr, extent.expand(cr.shape[0])))
    return gap


def frame_gap(c_prog, c_ref, c_start) -> float:
    fin_p, fin_r = np.isfinite(c_prog).all(), np.isfinite(c_ref).all()
    if not (fin_p and fin_r):
        return 0.0 if fin_p == fin_r else float("inf")
    moved = float(np.linalg.norm(c_ref - c_start)) if np.isfinite(c_start).all() else 1.0
    return float(np.linalg.norm(c_prog - c_ref)) / max(moved, 1e-3)


class Reference:
    """The reference's pieces for one configuration, eager, TF32 off."""

    def __init__(self, cfg_overrides: dict, K: np.ndarray, seed: int, device):
        from vo_bench.reference.config import load_config

        self.cfg = load_config(overrides=cfg_overrides)
        self.K = K
        self.device = torch.device(device)
        self.chain = KeyChain(seed)
        self.process = ref_pipeline.frame_step(
            ref_pipeline.make_process_frame(self.cfg, K, self.device))
        self.uniforms = ref_pipeline.uniforms_fn(self.cfg.ransac.pnp_hypotheses, self.device)
        self.ba_step = None
        if self.cfg.ba.enabled:
            self.ba_step = ref_pipeline.carry_step(
                ref_pipeline.make_ba_step(self.cfg, K, self.device))

    def host_loop(self):
        return ref_pipeline.VisualOdometry(self.cfg, self.K, self.device)

    def _frame(self, f) -> torch.Tensor:
        return torch.as_tensor(np.asarray(f)).to(self.device)

    def steps(self, s: Sample, frames: np.ndarray, n: int | None = None):
        """The reference's poses of the sample's first ``n`` frames (all it has poses
        for), from the program's state, and the state and window after them."""
        state, window = to_reference(s.state), to_reference(s.window)
        n = len(s.poses) if n is None else n
        if s.chunk:
            keys = jax_random.split(self.chain.key(s.keys[0]), s.chunk)[:n]
        else:
            keys = np.stack([self.chain.key(i) for i in s.keys[:n]])
        draws = self.uniforms(keys)
        every = self.cfg.ba.keyframe_every
        out = []
        for j in range(n):
            state, res = self.process(state, self._frame(frames[s.first + j]), draws[j])
            out.append((res.R.cpu().numpy(), res.t.cpu().numpy(), bool(res.pose_ok)))
            if self.ba_step is not None and (s.frame_idx + j + 1) % every == 0:
                (state, window), _ = self.ba_step((state, window))
        return out, state, window

    def bootstrap(self, s: Sample, frames: np.ndarray):
        """The reference's bootstrap pose on the sample's frames under the same key."""
        vo = self.host_loop()
        key = self.chain.key(s.keys[0])
        vo._next_key = lambda: key
        gap = self.cfg.bootstrap.frame_gap
        vo.bootstrap([frames[s.first + j] for j in range(gap + 1)])
        return [(vo.state.R.cpu().numpy(), vo.state.t.cpu().numpy(), True)]


def compare(ref: Reference, samples: list, frames: np.ndarray) -> dict:
    """Run the reference over every sample and return the readings: ``pose_gap`` (the
    largest gap), ``map_gap`` (the largest :func:`map_gap` after a full stretch of
    steps), the frames compared, and per kind the samples and their largest gap."""
    worst, worst_map, n_frames, per_kind = 0.0, 0.0, 0, {}
    with full_precision():
        for s in samples:
            if s.kind == "bootstrap":
                got = ref.bootstrap(s, frames)
                starts = [np.zeros(3)]
            else:
                got, state, window = ref.steps(s, frames)
                R0, t0 = s.state.R.cpu().numpy(), s.state.t.cpu().numpy()
                starts = [center(R0, t0)] * len(got)
                if s.end is not None:
                    worst_map = max(worst_map, map_gap(s.end, (state, window)))
            gaps = [frame_gap(center(Rp, tp), center(Rr, tr), c0)
                    for (Rp, tp, _), (Rr, tr, _), c0 in zip(s.poses, got, starts)]
            g = max(gaps, default=0.0)
            worst = max(worst, g)
            n_frames += len(gaps)
            k = per_kind.setdefault(s.kind, {"samples": 0, "frames": 0, "pose_gap": 0.0})
            k["samples"] += 1
            k["frames"] += len(gaps)
            k["pose_gap"] = max(k["pose_gap"], g)
    return {"pose_gap": worst, "map_gap": worst_map, "frames": n_frames, "by_kind": per_kind}


@contextlib.contextmanager
def full_precision():
    """float32 as the configurations state it: TF32 off for matmuls and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits (to nearest, ties to even)."""
    if x.dtype != torch.float32:
        return x
    b = x.contiguous().view(torch.int32)
    lsb = (b >> 13) & 1
    b = (b + 0x0FFF + lsb) & ~0x1FFF
    return torch.where(torch.isfinite(x), b.view(torch.float32), x)


class _TF32Products(torch.utils._python_dispatch.TorchDispatchMode):
    """The CPU's stand-in for TF32: the float32 operands of every matrix product and
    convolution rounded to TF32 before it runs (the card's tensor cores do this)."""

    OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "matmul", "convolution",
           "_convolution", "dot", "mv", "addmv"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.overloadpacket.__name__ in self.OPS:
            args = tuple(round_tf32(a) if torch.is_tensor(a) else a for a in args)
        return func(*args, **kwargs)


@contextlib.contextmanager
def tf32(device):
    """The control's precision, the nearest below float32 with TF32 off: TF32 products,
    the card's own on CUDA, rounded operands on the CPU."""
    if torch.device(device).type == "cuda":
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
    else:
        with _TF32Products():
            yield
