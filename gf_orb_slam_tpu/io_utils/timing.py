"""Per-frame stage timing — the reference's TimeLog system.

Mirrors Util.hpp:179-264 (TimeLog struct with per-stage wall-clock fields,
appended per frame and dumped by SaveTimeLog, Tracking.h:254-280): a
lightweight host-side stopwatch aggregating named stages per frame, with the
same dump format (header row + one line per frame) so the reference's offline
analysis scripts work on our logs.

The reference also uses timers as control inputs (anytime budgets); in this
rebuild budgets are static compute (selection rounds, candidate counts)
so the TimeLog here is purely observational.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


STAGES = (
    "extraction",
    "initial_track",
    "local_map_track",
    "gf_selection",
    "keyframe_insert",
    "triangulation",
    "fusion",
    "local_ba",
    "loop_closing",
    # Blocking host time spent WAITING on device results (pipelined-mode
    # finalize fetches, first-call XLA compiles). Kept out of the per-stage
    # columns so those stay attributable to work: otherwise warmup and fetch
    # stalls land inside whatever stage happens to be open.
    "pipeline_wait",
    "total",
)


@dataclass
class FrameTiming:
    timestamp: float
    stages_ms: dict = field(default_factory=dict)
    lmk_tracked: int = 0
    lmk_inlier: int = 0


class TimeLog:
    def __init__(self):
        self.frames: list[FrameTiming] = []
        self._current: FrameTiming | None = None
        self._t0: float = 0.0
        # Stage stack: stages nest (loop closing finalizes inside the tracked
        # frame's window), so begin/end must be re-entrant.
        self._stack: list[tuple[str, float]] = []
        # On-chip per-stage attribution from io_utils/stage_probe.py: the
        # fused per-frame/per-insertion programs expose only one host wall
        # time each, so the inner stages (gf_selection, triangulation,
        # fusion, local_ba, ...) are measured by chained-dispatch deltas of
        # program variants and attached here.
        self.device_stages_ms: dict | None = None

    def start_frame(self, timestamp: float):
        self._current = FrameTiming(timestamp=timestamp)
        self._t0 = time.perf_counter()

    def begin(self, stage: str):
        self._stack.append((stage, time.perf_counter()))

    def end(self, stage: str | None = None):
        if not self._stack:
            return
        name, t0 = self._stack.pop()
        if self._current is None:
            return  # e.g. flush() after the last frame — nothing to charge
        name = stage or name
        dt = (time.perf_counter() - t0) * 1e3
        self._current.stages_ms[name] = self._current.stages_ms.get(name, 0.0) + dt

    def end_frame(self, lmk_tracked: int = 0, lmk_inlier: int = 0):
        self._stack.clear()
        if self._current is None:
            return
        self._current.stages_ms["total"] = (time.perf_counter() - self._t0) * 1e3
        self._current.lmk_tracked = lmk_tracked
        self._current.lmk_inlier = lmk_inlier
        self.frames.append(self._current)
        self._current = None

    def save(self, path: str):
        """Dump in the reference's SaveTimeLog table style."""
        with open(path, "w") as f:
            f.write("#timestamp " + " ".join(STAGES) + " lmk_tracked lmk_inlier\n")
            for fr in self.frames:
                cols = " ".join(f"{fr.stages_ms.get(s, 0.0):.3f}" for s in STAGES)
                f.write(f"{fr.timestamp:.6f} {cols} {fr.lmk_tracked} {fr.lmk_inlier}\n")
            if self.device_stages_ms:
                f.write(
                    "#device-stage "
                    + " ".join(
                        f"{k}={v:.3f}" for k, v in self.device_stages_ms.items()
                    )
                    + "\n"
                )

    def summary(self) -> dict:
        if not self.frames:
            return {}
        out = {}
        for s in STAGES:
            # Aggregate only over frames where the stage actually ran: a
            # stage that fires on some frames (keyframe_insert, loop_closing)
            # must not report a median of 0.0, and a stage measured only on
            # chip (gf_selection, fusion, ...) must not fabricate host zeros.
            vals = sorted(
                fr.stages_ms[s] for fr in self.frames if s in fr.stages_ms
            )
            entry = {}
            if vals:
                entry = {
                    "n": len(vals),
                    "mean_ms": sum(vals) / len(vals),
                    # Median is the steady-state number: first-call XLA
                    # compiles land on single frames and dominate mean/max.
                    "median_ms": vals[len(vals) // 2],
                    "max_ms": vals[-1],
                }
            if self.device_stages_ms and s in self.device_stages_ms:
                entry["device_ms"] = self.device_stages_ms[s]
            if entry:
                out[s] = entry
        return out
