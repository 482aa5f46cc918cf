"""The benchmark of ``lcvo_tpu_torch`` on one card.

    python3 -m vo_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell of ``BENCHMARK.json`` names a configuration (``vo_bench/configs/<name>.json``: the
VO settings as overrides of ``VOConfig``) and a traffic mix
(``vo_bench/workloads/<name>.json``: the scene, the episode and how frames arrive). Set-up
imports the port, loads its kernel library (built into ``build/torch_ext`` at the first
run of a checkout), renders the episode on the card into host memory from the seed,
and warms the host loop up on its first frames (the bootstrap's and the steps' CUDA
graphs are captured there). Then the window:

- ``replay``: the recorded drive replayed as fast as the card allows, episode after
  episode through ``VisualOdometry.run_chunked`` (a bootstrap at each episode's start);
  ``frames_per_s`` is every frame whose pose reached the host in the window, bootstrap
  frames included, over the window's time.
- ``live``: frames due at a fixed rate through ``VisualOdometry.run`` (one ``step`` a
  frame, its pose read back), an open loop: each frame's latency runs from when it was
  due to when its pose is on the host.

``--trace 1`` runs the same window with ``torch.profiler`` over a sub-window of whole
chunks (or steps) and prints the per-layer metrics that ``vo_bench/metrics/<name>.py``
read. After the window the plain reference checks what the window produced
(``vo_bench/check.py``) and the last line of standard output is one JSON object.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "lcvo_tpu")
RENDER_BATCH = 64


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as fh:
        return json.load(fh)


def find_cell(name: str, bench: dict | None = None) -> dict:
    """A cell of ``BENCHMARK.json`` with its configuration, traffic mix, limits and
    metrics, each found by name."""
    bench = bench or load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    return {
        "cell": w,
        "config": load_json(ROOT, conf["file"]),
        "traffic": load_json(HERE, "workloads", w["traffic"] + ".json"),
        "limits": load_json(HERE, "limits", name + ".json"),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def reader(metric: str):
    """The ``read(ctx)`` function of ``vo_bench/metrics/<metric>.py``."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location("vo_bench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------


def scene(traffic: dict, width: int, height: int, n_frames: int, seed: int, device):
    """The renderer of the traffic's scene, its texture keyed by ``seed``."""
    from vo_bench import scene as sc

    s = traffic["scene"]
    if s["kind"] == "corridor":
        far = max(400.0, n_frames * s["speed"] + 500.0)
        return sc.FastCorridorRenderer(n_frames, width, height, speed=s["speed"],
                                       world=sc.CorridorWorld(end_z=far, seed=seed),
                                       device=device)
    if s["kind"] == "arena":
        traj = sc.trajectory_loop(n_frames, s["speed"], straight_frames=s["straight_frames"],
                                  turn_frames=s["turn_frames"])
        return sc.FastArenaRenderer(traj, width, height, margin=s.get("margin", 8.0),
                                    seed=seed, device=device)
    raise ValueError(f"unknown scene kind {s['kind']!r}")


def render(traffic: dict, width: int, height: int, n_frames: int, seed: int, device):
    """(n_frames, H, W) uint8 frames of the episode's first ``n_frames`` in host memory,
    rendered on ``device`` a batch per call, and the camera matrix."""
    import torch

    r = scene(traffic, width, height, traffic["episode_frames"], seed, device)
    out = np.empty((n_frames, height, width), np.uint8)
    with torch.no_grad():
        for a in range(0, n_frames, RENDER_BATCH):
            b = min(a + RENDER_BATCH, n_frames)
            out[a:b] = r.frames_device(a, b).cpu().numpy()
    return out, r.K


def frames_needed(traffic: dict, seconds: float, gap: int) -> int:
    """Frames a run renders: the whole episode for a replay, what the window's rate
    asks for (and the warm-up) for a live camera."""
    n = traffic["episode_frames"]
    if traffic["mode"] == "live":
        n = min(n, gap + 2 + max(traffic["warmup_frames"],
                                 math.ceil(traffic["rate_hz"] * seconds)))
    return n


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


class Driver:
    """Drives a host loop through the window and keeps what the metrics and the check
    read: the harness's spans around the host loop's ``bootstrap`` and ``step``, the
    count of keys the loop's chain has handed out, the poses and when they reached the
    host, clones of the loop's state at sampled boundaries, and the profiled
    sub-window."""

    def __init__(self, vo, cfg, traffic: dict, seed: int, trace: bool, device):
        self.vo, self.cfg, self.traffic, self.trace, self.device = vo, cfg, traffic, trace, device
        self.gap = cfg.bootstrap.frame_gap
        self.keys = 0                 # keys the loop's chain has handed out
        self.pending = None           # the host-loop call whose poses come next
        self.last_boot = None
        self.steps_since_boot = 0
        self.in_window = False
        self.profiling = None
        self.host_step_ms: list = []
        self.samples: list = []       # check.Sample
        self.open: list = []          # samples still collecting poses
        self.rng = np.random.default_rng(seed)
        chk = traffic["check"]
        self.check_every, self.check_frames = chk["every"], chk["frames"]
        self.check_offset = int(self.rng.integers(chk["every"]))
        self.profile = None           # the finished profile: trace summary and its inputs
        self.span = {"t0": 0.0, "deadline": 0.0}
        self.boots = [0, 0]           # bootstraps in the window: [fresh, re-bootstraps]
        self.events, self.latencies, self.attempted, self.failed = [], [], 0, 0
        boot, step = vo.bootstrap, vo.step

        def bootstrap(frames, R0=None, t0=None, scale=None):
            self.keys += 1
            key = self.keys
            n = boot(frames, R0=R0, t0=t0, scale=scale)
            self.last_boot = {"key": key, "frames": len(frames), "anchored": R0 is not None,
                              "n": n}
            if self.in_window:
                self.boots[self.last_boot["anchored"]] += 1
            self.pending = "bootstrap"
            self.steps_since_boot = 0
            return n

        def timed_step(image):
            self.keys += 1
            self.step_key = self.keys
            a = time.perf_counter()
            res = step(image)
            b = time.perf_counter()
            if self.in_window and self.profiling is None:
                self.host_step_ms.append((b - a) * 1e3)
            self.steps_since_boot += 1
            self.pending = "step"
            return res

        vo.bootstrap, vo.step = bootstrap, timed_step

    # -- the check's samples ----------------------------------------------------
    def _clone(self):
        from vo_bench import check

        return (check.clone_tree(self.vo.state), check.clone_tree(self.vo.window),
                self.vo._frame_idx)

    def _snapshot(self, first: int, chunk: int):
        from vo_bench import check

        state, window, fidx = self._clone()
        s = check.Sample("steps", first, [], state=state, window=window, frame_idx=fidx,
                         chunk=chunk)
        self.open.append(s)

    def _feed(self, kind: str, first: int, Rs, ts, oks, key: int):
        """Hand an event's poses to the samples still collecting: a chunk fills a
        sample of the chunk path, steps one of the step path; anything else ends it. A
        sample that is full keeps the host loop's state and window after it."""
        keep = []
        for s in self.open:
            if s.chunk and kind == "chunk" and s.first == first:
                s.keys = [key]
                s.poses = [(Rs[j], ts[j], bool(oks[j])) for j in range(self.check_frames)]
                if self.check_frames == len(Rs):
                    s.end = self._clone()[:2]
                self.samples.append(s)
            elif not s.chunk and kind == "step" and s.first + len(s.poses) == first:
                s.keys.append(key)
                s.poses.append((Rs[0], ts[0], bool(oks[0])))
                if len(s.poses) == self.check_frames:
                    s.end = self._clone()[:2]
                    self.samples.append(s)
                else:
                    keep.append(s)
            elif not s.chunk and s.poses:
                self.samples.append(s)           # a stretch of steps cut by a bootstrap
        self.open = keep

    def _boot_sample(self, R, t):
        from vo_bench import check

        b = self.last_boot
        if b["anchored"] or b["frames"] != self.gap + 1:
            return
        self.samples.append(check.Sample("bootstrap", 0, [b["key"]], poses=[(R, t, True)]))

    def chosen_samples(self, n_steps: int) -> list:
        """Every bootstrap sample and ``n_steps`` of the others, drawn from the seed."""
        boots = [s for s in self.samples if s.kind == "bootstrap"]
        steps = [s for s in self.samples if s.kind == "steps" and s.poses]
        if len(steps) > n_steps:
            pick = sorted(self.rng.choice(len(steps), n_steps, replace=False))
            steps = [steps[i] for i in pick]
        return boots + steps

    # -- the profiled sub-window -------------------------------------------------
    def _profile_start(self, first: int, chunk: int):
        import torch
        from torch.profiler import ProfilerActivity, profile

        state, window, fidx = self._clone()
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.profiling = {"prof": prof, "events": 0, "frames": 0, "first": first,
                          "chunk": chunk, "keys": [], "state": state, "window": window,
                          "frame_idx": fidx, "latencies_before": len(self.latencies),
                          "host_steps_before": len(self.host_step_ms)}
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        prof.start()
        self.profiling["t0"] = time.perf_counter()

    def _profile_event(self, kind: str, n_frames: int, key: int, length: int):
        """One more event inside the profiled sub-window; stop after ``length`` events
        of the window's own kind, drop the profile at any other kind."""
        p = self.profiling
        want = "chunk" if self.traffic["mode"] == "replay" else "step"
        if kind != want:
            p["prof"].stop()
            self.profiling = None
            return
        p["events"] += 1
        p["frames"] += n_frames
        p["keys"].append(key)
        if p["events"] == length:
            p["window_us"] = (time.perf_counter() - p["t0"]) * 1e6
            p["prof"].stop()
            self.profile = p
            self.profiling = None

    # -- replay -----------------------------------------------------------------
    def replay(self, frames: np.ndarray, seconds: float) -> dict:
        chunk = self.traffic["chunk"]
        tr = self.traffic.get("trace", {})
        gap = self.gap
        state = {"pos": 0, "chunks": 0}

        def frames_until(deadline):
            for i in range(len(frames)):
                if i > gap and time.perf_counter() >= deadline:
                    return
                yield frames[i]

        def on_chunk(start, Rs, ts, oks, ninl):
            now = time.perf_counter()
            kind = self.pending or "chunk"
            self.pending = None
            if kind == "chunk":
                self.keys += 1
            key = self.keys if kind == "chunk" else (
                self.last_boot["key"] if kind == "bootstrap" else self.step_key)
            first = state["pos"]
            fresh = kind == "bootstrap" and not self.last_boot["anchored"]
            used = gap + 1 if fresh else len(Rs)
            state["pos"] += used
            if now <= deadline:
                self.events.append((now, used))
                self.attempted += used
                self.failed += int(sum(not (np.isfinite(R).all() and np.isfinite(t).all())
                                       for R, t in zip(Rs, ts)))
            pose_first = state["pos"] - len(Rs)
            if self.profiling is not None:
                self._profile_event(kind, len(Rs), key, tr.get("length", 2))
            self._feed(kind, pose_first, Rs, ts, oks, key)
            if kind == "bootstrap" and fresh:
                self._boot_sample(Rs[0], ts[0])
                self._snapshot(state["pos"], chunk)
            if kind == "chunk":
                state["chunks"] += 1
                if (state["chunks"] - self.check_offset) % self.check_every == 0:
                    self._snapshot(state["pos"], chunk)
                if (self.trace and self.profile is None and self.profiling is None
                        and state["chunks"] >= tr.get("after", 0)):
                    self._profile_start(state["pos"], chunk)

        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.span = {"t0": t0, "deadline": deadline}
        self.in_window = True
        while time.perf_counter() < deadline:
            state["pos"] = 0
            self.vo.run_chunked(frames_until(deadline), chunk=chunk, on_chunk=on_chunk)
        self.in_window = False
        self._feed("end", -1, [], [], [], 0)
        return self.span

    # -- live ---------------------------------------------------------------------
    def live(self, frames: np.ndarray, seconds: float) -> dict:
        rate = float(self.traffic["rate_hz"])
        tr = self.traffic.get("trace", {})
        gap = self.gap
        every = self.cfg.ba.keyframe_every if self.cfg.ba.enabled else 0
        due: dict = {}                # global frame number -> when it was due
        state = {"entries": 0, "steps": 0, "g0": 0}

        def paced(deadline, t0):
            """The episode's frames, each handed over when it is due (global frame
            number ``g0 + i`` at ``t0 + (g0 + i) / rate``), until one is due after the
            deadline."""
            for i in range(len(frames)):
                g = state["g0"] + i
                d = t0 + g / rate
                if d > deadline:
                    return
                while True:
                    wait = d - time.perf_counter()
                    if wait <= 0:
                        break
                    time.sleep(wait if wait > 2e-3 else 0)
                due[g] = d
                self.attempted += 1
                yield frames[i]

        def on_frame(idx, res):
            now = time.perf_counter()
            kind = self.pending or "hold"
            self.pending = None
            frame = gap + state["entries"]         # one pose a frame from frame gap on
            state["entries"] += 1
            R, t = res.R.cpu().numpy(), res.t.cpu().numpy()
            ok = bool(res.pose_ok)
            if not (np.isfinite(R).all() and np.isfinite(t).all()):
                self.failed += 1
            keyframe = kind == "step" and every and self.steps_since_boot % every == 0
            self.latencies.append(((now - due[state["g0"] + frame]) * 1e3, bool(keyframe)))
            key = self.step_key if kind == "step" else (
                self.last_boot["key"] if kind == "bootstrap" else 0)
            if self.profiling is not None:
                self._profile_event(kind, 1, key, tr.get("length", 32))
            self._feed(kind, frame, [R], [t], [ok], key)
            if kind == "bootstrap":
                self._boot_sample(R, t)
                self._snapshot(frame + 1, 0)
            if kind == "step":
                state["steps"] += 1
                if (state["steps"] - self.check_offset) % self.check_every == 0:
                    self._snapshot(frame + 1, 0)
                if (self.trace and self.profile is None and self.profiling is None
                        and state["steps"] >= tr.get("after", 0)):
                    self._profile_start(frame + 1, 0)

        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.span = {"t0": t0, "deadline": deadline}
        self.in_window = True
        # episodes back to back, while a bootstrap's frames still fall in the window
        while t0 + (state["g0"] + gap + 1) / rate <= deadline:
            self.vo.run(paced(deadline, t0), n_frames=len(frames), on_frame=on_frame)
            state["g0"] += len(frames)
            state["entries"] = 0
        self.in_window = False
        self._feed("end", -1, [], [], [], 0)
        return self.span


def warm_up(drv: Driver, frames: np.ndarray) -> None:
    """The host loop's first run over the episode's first frames: every graph the
    window replays is captured here (bootstrap pieces, the step, the keyframe step, a
    chunk's draws; the tail frames take the per-frame path). The driver keeps counting
    the keys the loop hands out."""
    traffic = drv.traffic
    n = min(len(frames), drv.gap + 1 + traffic["warmup_frames"])

    def count(*_):                        # a chunk's poses come with no call of its own
        if drv.pending is None:
            drv.keys += 1
        drv.pending = None

    def clear(*_):
        drv.pending = None

    if traffic["mode"] == "replay":
        drv.vo.run_chunked(frames[:n], chunk=traffic["chunk"], on_chunk=count)
    else:
        drv.vo.run(iter(frames[:n]), n_frames=n, on_frame=clear)


# ---------------------------------------------------------------------------
# the reference's replay of the profiled sub-window: the arguments of each kernel's call
# ---------------------------------------------------------------------------


def replay_calls(ref, prof: dict, frames: np.ndarray) -> dict:
    """The reference's replay of the profiled chunks (or steps) from the state they
    started from, with the arguments of each call of the ops that stand for the
    program's kernels (``reference/calls.py``), by op in call order: the calls the
    program's kernels made there."""
    from vo_bench import check
    from vo_bench.reference import calls

    chunk = prof["chunk"]
    s = check.Sample("steps", prof["first"], list(prof["keys"]), state=prof["state"],
                     window=prof["window"], frame_idx=prof["frame_idx"], chunk=chunk)
    calls.RECORD = {}
    try:
        with check.full_precision():
            if not chunk:
                ref.steps(s, frames, len(s.keys))
            else:
                for key in prof["keys"]:
                    s.keys = [key]
                    _, state, window = ref.steps(s, frames, chunk)
                    s = check.Sample("steps", s.first + chunk, [], state=state,
                                     window=window, frame_idx=s.frame_idx + chunk, chunk=chunk)
        return calls.RECORD
    finally:
        calls.RECORD = None


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def short(name: str, n: int = 160) -> str:
    """A kernel's name cut to ``n`` characters (template arguments run to thousands)."""
    return name if len(name) <= n else name[:n - 3] + "..."


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             system: str = "program", t_start: float | None = None) -> dict:
    """One run of a cell (``find_cell``'s ``spec``): set-up, the window, the check.
    ``system`` is ``program`` (the port) or ``control`` (the reference in TF32 in the
    port's place). Returns the result line's object, and under ``_stderr`` the lines
    that end standard error."""
    import torch

    from vo_bench import check

    t_start = T_START if t_start is None else t_start
    cfg_doc, traffic = spec["config"], spec["traffic"]
    cuda = torch.device(device).type == "cuda"
    notes = {}
    overrides = dict(cfg_doc["overrides"], seed=int(seed))
    if system == "program":
        from lcvo_tpu_torch import kernels
        from lcvo_tpu_torch.config import load_config
        from lcvo_tpu_torch.pipeline import VisualOdometry

        if cuda:
            kernels.library()
        cfg = load_config(overrides=overrides)
    else:
        from vo_bench.reference.config import load_config

        cfg = load_config(overrides=overrides)
    gap = cfg.bootstrap.frame_gap
    t = time.perf_counter()
    frames, K = render(traffic, cfg.image_width, cfg.image_height,
                       frames_needed(traffic, seconds, gap), seed, device)
    notes["render_s"] = time.perf_counter() - t
    ref = check.Reference(overrides, K, seed, device)
    if system == "program":
        vo = VisualOdometry(cfg, K, device)
        precision = check.full_precision
    else:
        vo = ref.host_loop()
        precision = lambda: check.tf32(device)   # noqa: E731
    drv = Driver(vo, cfg, traffic, seed, trace, device)
    t = time.perf_counter()
    failure = None
    try:
        with precision():
            warm_up(drv, frames)
    except Exception as exc:  # the program failing: a run that is not correct
        failure = f"{type(exc).__name__}: {exc}"
        traceback.print_exc(file=sys.stderr)
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(8, device=device).sum().item()
    if cuda:
        torch.cuda.synchronize()
    notes["warm_up_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start

    win = drv.span
    try:
        if failure is None:
            with precision():
                win = (drv.replay if traffic["mode"] == "replay" else drv.live)(frames, seconds)
    except Exception as exc:
        failure = f"{type(exc).__name__}: {exc}"
        traceback.print_exc(file=sys.stderr)
    if cuda:
        torch.cuda.synchronize()
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()
    notes["bootstraps"], notes["rebootstraps"] = drv.boots
    if system == "program":
        gs = vo.graph_stats()["graphs"]
        notes["graphs"] = len(gs)
        notes["graph_setup_s"] = sum(g.get(k, 0.0) for g in gs
                                     for k in ("warmup_s", "capture_s", "instantiate_s"))
    drv.vo = vo = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the end-to-end metrics ------------------------------------------------
    from vo_bench import stats

    e2e = {"setup_s": setup_s}
    if traffic["mode"] == "replay" and drv.events:
        fps, done, secs = stats.rate(drv.events, win["t0"], win["deadline"])
        e2e["frames_per_s"] = fps
        gaps = np.diff([t for t, _ in drv.events]) * 1e3
        notes.update(frames_done=done, window_s=secs)
        if len(gaps):
            notes["event_ms_p10_p50_p90"] = np.percentile(gaps, [10, 50, 90]).tolist()
            notes["event_ms_p50_by_quarter"] = [float(np.median(q)) for q in
                                                np.array_split(gaps, 4) if len(q)]
    elif traffic["mode"] == "live" and drv.latencies:
        lat = [ms for ms, _ in drv.latencies]
        e2e["latency_p50_ms"] = stats.percentile(lat, 50)
        e2e["latency_p95_ms"] = stats.percentile(lat, 95)
        q = len(lat) // 4
        growth = stats.median(lat[3 * q:]) - stats.median(lat[q:2 * q]) if q else 0.0
        notes.update(poses=len(lat), latency_p95_ms=e2e["latency_p95_ms"],
                     latency_max_ms=max(lat), growth_ms=growth)
        if drv.host_step_ms:
            notes["host_step_ms_p10_p50_p90"] = np.percentile(drv.host_step_ms,
                                                              [10, 50, 90]).tolist()

    # -- the check --------------------------------------------------------------
    t = time.perf_counter()
    # the cell's limits: the numbers of its limits file (the rest is their readings)
    limits = {k: v for k, v in spec["limits"].items() if isinstance(v, (int, float))}
    samples = drv.chosen_samples(traffic["check"]["samples"])
    try:
        if failure:
            raise RuntimeError(f"the window failed: {failure}")
        readings = check.compare(ref, samples, frames)
    except Exception as exc:  # the reference failing is a failed check, not a crash
        readings = {"error": f"{type(exc).__name__}: {exc}", "frames": 0}
    got = {k: readings.get(k, float("inf")) for k in limits}
    correct = bool(readings["frames"] > 0 and all(got[k] <= v for k, v in limits.items()))
    notes["check_s"] = time.perf_counter() - t
    notes["check"] = readings

    # -- the per-layer metrics ----------------------------------------------------
    out_metrics: dict = {}
    breakdown = None
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace:
        from vo_bench import trace as tr

        prof = drv.profile
        summary, made = None, {}
        # what the live loop did before the profiler started: the profiler's own stall
        # at its end backs the queue up for the rest of the window
        host_ms, lat = drv.host_step_ms, drv.latencies
        if prof is not None:
            t = time.perf_counter()
            summary = tr.summarize(prof.pop("prof"), prof["window_us"], prof["frames"])
            notes["trace_read_s"] = time.perf_counter() - t
            host_ms = host_ms[:prof["host_steps_before"]]
            lat = lat[:prof["latencies_before"]]
            t = time.perf_counter()
            made = replay_calls(ref, prof, frames)
            notes["calls_replay_s"] = time.perf_counter() - t
            prof = {k: prof[k] for k in ("first", "chunk", "keys", "frames", "frame_idx")}
        ctx = SimpleNamespace(mode=traffic["mode"], cfg=cfg, trace=summary, calls=made,
                              profiled=prof, host_step_ms=host_ms, latencies=lat)
        for m in spec["per_layer"]:
            v = reader(m["name"])(ctx)
            if v is not None:
                out_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if summary is not None and cuda:
            dev["busy_s"] = summary["busy_us"] * 1e-6
            dev["window_s"] = summary["window_us"] * 1e-6
            breakdown = {k: [[short(n), v] for n, v in summary[src][:10]]
                         for k, src in (("device_ops", "top_ops"), ("idle_gaps", "gaps"))}
    else:
        for m in spec["end_to_end"]:
            if m["name"] in e2e:
                out_metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

    result = {"correct": correct, "attempted": int(drv.attempted), "failed": int(drv.failed),
              "metrics": out_metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    checks = {k: {"value": got[k], "limit": v} for k, v in limits.items()}
    checks["frames_compared"] = {"value": readings["frames"], "limit": 1}
    result["checks"] = checks
    result["_notes"] = notes
    result["_forbidden"] = found
    result["_stderr"] = [f"check {k}: {v['value']} (limit {v['limit']})"
                         for k, v in checks.items()]
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = find_cell(args.workload)

    # caches of the program inside the checkout, at fixed paths
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    os.environ["USE_FLAX"] = "0"
    import torch

    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"vo_bench: {args.workload} needs {chips} CUDA device(s), this machine has {n}",
              file=sys.stderr)
        return 3
    torch.cuda.reset_peak_memory_stats()
    return emit(run_cell(spec, args.seed, args.seconds, bool(args.trace)))


def emit(res: dict) -> int:
    """Print a run's result: notes, then the numbers compared beside their limits as the
    last lines of standard error, and the result's line as the last line of standard
    output. Prints no result, and returns 4, when the process holds JAX or the JAX
    package."""
    notes, found, tail = res.pop("_notes"), res.pop("_forbidden"), res.pop("_stderr")
    found = sorted(set(found) | set(forbidden_modules()))
    print("vo_bench notes: " + json.dumps(notes, default=str), file=sys.stderr)
    if found:
        print(f"vo_bench: the process holds {found} after the window: the benchmark may not "
              f"load JAX or the JAX package", file=sys.stderr)
        return 4
    for line in tail:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
