"""A cell cut to a size the CPU runs in seconds: 320x128 frames, 256 tracks, a short
episode, a sample at every boundary."""

from __future__ import annotations

import copy
import time

from vo_bench import run

SEED = 3000000017


def tiny_spec(cell: str, check_frames: int = 3) -> dict:
    spec = copy.deepcopy(run.find_cell(cell))
    spec["config"]["overrides"].update(
        image_width=320, image_height=128,
        state={"max_tracks": 256, "max_candidates": 256, "max_new_per_frame": 128})
    t = spec["traffic"]
    t.update(episode_frames=80, warmup_frames=20)
    t["check"].update(every=1, samples=3, frames=check_frames)
    if t["mode"] == "live":
        t["rate_hz"] = 5.0
    t["trace"] = {"after": 1, "length": 1} if t["mode"] == "replay" else {"after": 8, "length": 3}
    return spec


def tiny_run(cell: str, seconds: float = 5.0, system: str = "program", trace: bool = False,
             seed: int = SEED, check_frames: int = 3) -> dict:
    return run.run_cell(tiny_spec(cell, check_frames), seed, seconds, trace, device="cpu", system=system,
                        t_start=time.perf_counter())
