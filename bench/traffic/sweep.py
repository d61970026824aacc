"""Driver of a camera stream: synthetic video frames through the program's
`StreamingPipeline` in throughput mode, each frame swept whole by
`FcnSweep` on a `VisionEngine`'s backend and params.

Set-up (counted in `setup_s`): the params and `distinct_frames` frames of
a seeded clip, rendered once and looped through the window (the sweep
keeps nothing from one frame to the next); the pipeline, whose
constructor sweeps one frame of the stream's shape to warm it.  Also in
set-up, but timed apart (`reference_s`) and left out of `setup_s`: the
detection threshold, the `threshold_percentile`-th percentile of the
first frame's per-window top confidence as the reference computes it.
The window: frames are offered as fast as the pipeline takes them until
the close; those in flight then finish.  `frames_per_s` counts the frames
delivered by the close over the window's seconds.  Every delivered
frame's window scores and detections are then compared with the
reference's for its frame.

Mix parameters: frame_shape, distinct_frames, n_objects, stride,
min_dist, threshold_percentile, queue_size.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
import time

import numpy as np

from bench import harness, judge, program
from bench.reference import smallnet as ref
from bench.reference import sweep as rs
from bench.trace import DeviceTrace, GcPauses, HostSpans
from bench.traffic import render

KIND = "sweep"
PATCH = 28


class _Source:
    """The looped clip, offered until the window closes."""

    def __init__(self, frames: list[np.ndarray]):
        self.frames = frames
        self.frame_shape = frames[0].shape[:2]
        self.t_close = None

    def __iter__(self):
        from repro_torch.streaming.sources import Frame
        i = 0
        while True:
            if time.perf_counter() >= self.t_close:
                return
            yield Frame(index=i, pixels=self.frames[i % len(self.frames)], truth=[])
            i += 1


def _recording_sweep(**kw):
    """`FcnSweep` that keeps every window-score array its aggregate stage
    receives, in frame order (the pipeline's one aggregate stage serves
    frames in the order they came), and the threads its sweeps ran on."""
    from repro_torch.streaming.fcn_sweep import FcnSweep

    @dataclasses.dataclass(frozen=True)
    class RecordingSweep(FcnSweep):
        record: list = dataclasses.field(default_factory=list, compare=False)
        threads: set = dataclasses.field(default_factory=set, compare=False)

        def score(self, *a, **kw):
            self.threads.add(threading.get_ident())
            return super().score(*a, **kw)

        def aggregate(self, scores, positions, tiles=None):
            self.record.append(scores)
            return super().aggregate(scores, positions, tiles)

    return RecordingSweep(**kw)


class Run:
    def __init__(self, cell: harness.Cell, seed: int, seconds: float, *,
                 device: str = "cuda", backend=None, score_fmt: dict | None = None,
                 scorer=None):
        """`backend` puts another backend in the program's place, whose
        scores are words of `score_fmt` where that is given; `scorer`,
        (params, (1,H,W,1) frame) -> window scores, another sweep."""
        self.cell, self.seed, self.seconds, self.device = cell, seed, float(seconds), device
        self.mix = cell.mix
        self._backend, self._score_fmt, self._scorer = backend, score_fmt, scorer
        self.trace: dict | None = None

    def _ref_scores(self, frame: np.ndarray) -> np.ndarray:
        fmt = program.score_format(self.cell.config)
        fn = ((lambda c: ref.net_words(self.params, c, fmt)) if fmt is not None
              else (lambda c: ref.net_float(self.params, c)))
        return rs.window_scores(frame, self.positions, fn)

    # -- set-up -----------------------------------------------------------------

    def setup(self) -> None:
        from repro_torch.serving.vision_engine import VisionEngine
        from repro_torch.streaming.pipeline import StreamConfig, StreamingPipeline
        mix, cfg = self.mix, self.cell.config
        shape = tuple(mix["frame_shape"])
        self.params = harness.params_for(self.cell.config, self.seed)
        self.frames = render.video_frames(mix["distinct_frames"], shape,
                                          seed=int(np.random.default_rng([self.seed, 0x71D]).integers(2**31)),
                                          n_objects=mix["n_objects"])
        self.positions = rs.positions(shape, PATCH, mix["stride"])
        self.ref_fmt = program.score_format(cfg)
        t_ref = time.perf_counter()
        first = self._ref_scores(self.frames[0])
        self._ref_cache = {0: first}
        self.threshold = rs.percentile_threshold(rs.confidences(first, self.ref_fmt),
                                                 mix["threshold_percentile"])
        self.reference_s = time.perf_counter() - t_ref
        be = self._backend if self._backend is not None else program.backend(cfg)
        self.fmt = program.score_format(cfg, self._score_fmt)
        self.engine = VisionEngine(program.params_on(self.params, self.device), backend=be,
                                   device=self.device, warmup=False)
        self.sweep = _recording_sweep(stride=mix["stride"], threshold=self.threshold,
                                      min_dist=mix["min_dist"],
                                      cfg=program.tiler_cfg(self.fmt))
        if self._scorer is not None:
            scorer, params = self._scorer, self.params
            object.__setattr__(self.sweep, "score",
                               lambda _p, frames, **_kw: scorer(params, frames))
        self.source = _Source(self.frames)
        self.source.t_close = float("inf")
        self.pipe = StreamingPipeline(
            self.source, self.engine, self.sweep,
            config=StreamConfig(deadline_ms=None, queue_size=mix["queue_size"], realtime=False))
        # the set-up's objects leave the collector's view, as in the fleet
        gc.collect()
        gc.freeze()

    # -- the window ---------------------------------------------------------------

    def window(self, trace: bool = False) -> None:
        spans = HostSpans() if trace else None
        if trace:
            spans.wrap(self.sweep, "score", "FcnSweep.score")
            spans.wrap(self.sweep, "aggregate", "Tiler.aggregate")
        dt = DeviceTrace() if trace else contextlib.nullcontext()
        gcp = GcPauses()
        self.sweep.threads.clear()
        with dt, gcp:
            t_open = time.perf_counter()
            self.source.t_close = t_open + self.seconds
            results = self.pipe.run()
        self.gc = gcp.summary()
        t_close = self.source.t_close
        self.results = results
        self.scores = self.sweep.record
        done = np.array([r.t_done for r in results if r.t_done <= t_close]) - t_open
        self.frames_done = len(done)
        # frames delivered in each fifth of the window: a rate that drifts
        # within a run shows here (standard error)
        self.by_fifth = np.histogram(done, bins=5, range=(0.0, self.seconds))[0].tolist()
        self.stats = self.pipe.stats()
        if trace:
            s = dt.summary()
            s["idle_gaps"] = spans.label_gaps(
                s.pop("gaps"), ["FcnSweep.score", "Tiler.aggregate"],
                "pipeline outside the sweep and the aggregate")
            self.trace = s

    def release(self) -> None:
        import torch
        gc.unfreeze()
        self.pipe = self.engine = None
        if self.device == "cuda":
            torch.cuda.empty_cache()

    # -- results ---------------------------------------------------------------------

    @property
    def attempted(self) -> int:
        return int(self.stats["frames_in"])

    @property
    def failed(self) -> int:
        return self.attempted - len(self.results)

    def record(self) -> dict:
        stage = self.stats["stage"]
        return {"kind": KIND, "cell": self.cell.name, "config": self.cell.config,
                "seconds": self.seconds, "frames_done": self.frames_done,
                "frames_swept": len(self.results),
                "frames_by_fifth": self.by_fifth,
                "frame_shape": tuple(self.mix["frame_shape"]),
                "n_windows": len(self.positions),
                "stage_p50_ms": {k: stage[k].get("p50_ms") for k in stage},
                "trace": self.trace,
                "notes": f"gc during the window: {self.gc}; frames by fifth of the window "
                         f"{self.by_fifth}; sweeps ran on {len(self.sweep.threads)} threads; "
                         f"reference in set-up {self.reference_s:.3f} s"}

    def check(self) -> list[harness.Compared]:
        limits = self.cell.workload["limits"]
        exact = self.ref_fmt is not None
        D = len(self.frames)
        out = [harness.Compared("frames_undelivered", self.failed, limits["frames_undelivered"])]
        if len(self.scores) != len(self.results):
            return out + [harness.Compared("scores_unmatched", abs(len(self.scores) - len(self.results)), 0)]
        by_frame: dict[int, list[int]] = {}
        for k, r in enumerate(self.results):
            by_frame.setdefault(r.index % D, []).append(k)
        got, want, dets_differ = [], [], 0
        judged: dict[tuple[int, bytes], list] = {}
        for d, ks in sorted(by_frame.items()):
            if d not in self._ref_cache:
                self._ref_cache[d] = self._ref_scores(self.frames[d])
            w = self._ref_cache[d]
            wconf = rs.confidences(w, self.ref_fmt)
            for k in ks:
                s = program.as_reference_words(self.scores[k], self.fmt, self.ref_fmt)
                got.append(s)
                want.append(w)
                # exact: the reference's own detections; float: the
                # reference's deduplication of the program's own scores
                key = (d, b"" if exact else np.ascontiguousarray(s).tobytes())
                if key not in judged:
                    conf = wconf if exact else rs.confidences(s, None)
                    judged[key] = rs.detections(conf, self.positions, self.threshold,
                                                self.mix["min_dist"])
                mine = [(x.label, x.score, x.y, x.x) for x in self.results[k].detections]
                dets_differ += int(mine != judged[key])
        out += judge.scores(np.concatenate(got), np.concatenate(want), None, exact, limits,
                            prefix="window_")
        out.append(harness.Compared("frames_detections_differ", dets_differ,
                                    limits["frames_detections_differ"]))
        return out
