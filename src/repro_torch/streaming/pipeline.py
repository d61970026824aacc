"""Deadline-scheduled asyncio pipeline: ingest -> tile -> infer -> aggregate.

Port of `repro.streaming.pipeline`.  The camera does not wait for the
fabric, so a slow stage means dropped frames, not unbounded queues:

  ingest     pulls frames from a source (a `PacedPlayer` for real-time, any
             `FrameSource` for max-throughput runs) and admits them to a
             BOUNDED queue.  Real-time mode never blocks the camera: a full
             queue triggers the explicit drop policy ("newest" refuses the
             arriving frame, "oldest" evicts the stalest queued frame).
             Throughput mode blocks instead — backpressure propagates to
             the source and nothing drops.
  tile       sliding-window extraction (`streaming/tiler.py`), or — when the
             tiler is a full-frame sweep (`streaming/fcn_sweep.FcnSweep`,
             `tiler.sweep` is True) — just the window-position bookkeeping:
             the frame itself rides the queue as a single "tile".
  infer      one batched wave through a `VisionEngine` (any object with
             `serve()`), run in a worker thread so the event loop keeps
             ingesting on schedule.  In sweep mode the wave is instead ONE
             full-frame sweep, `FcnSweep.score` on the engine's params and
             backend, on the engine's device (one `frame_trunk` launch and
             one head launch on `fixed_cuda`); an engine with a callable
             `score_frame` (`serving/disagg.DisaggServer`) scores the frame
             itself, through its trunk and head pools.  One call runs on
             the event loop's thread instead: a sweep whose frame graph is
             already captured (`FcnSweep.replay` returns its scores, None
             where there is no graph), a replay that holds the loop ~0.15
             ms.  Sending it to a worker cost more than the replay: the
             hop, and the interpreter lock passed back and forth with the
             loop's stages at each of the replay's releases.  The capture,
             an eager sweep, the engine's waves and `score_frame`, which
             can take milliseconds, stay on the workers.  The registry
             counter `stream_infer_thread` (label `thread`: "loop" or
             "worker"), the infer span's `thread` tag and `stats()`'s
             `infer_thread` count where each wave ran.
  aggregate  confidence thresholding + dedup -> `FrameResult` (identical
             code path for both tilers: scores in, Detections out).

Every frame's age is checked against the per-frame deadline at each stage
boundary; a miss is COUNTED (reason + stage), never silently lost — the
invariant `frames_in == served + dropped` is part of `stats()`.

Observability (`repro_torch/obs/`): per-stage latency histograms and drop
counters live in the process-wide metrics registry, and with tracing
enabled (`obs.trace.enable()`) every frame carries a root span
`frame-<index>` with tile/infer/aggregate child spans and exactly one
terminal status — "served" or "dropped:<stage>/<reason>".  A deadline miss
or a broken ledger trips the flight recorder.  On the disaggregated
(`score_frame`) route the infer span's `route` tag is "disagg", and a
query the server sheds (an exception with a `.reason`) is a dropped frame.
"""
from __future__ import annotations

import asyncio
import dataclasses
import inspect
import time
from typing import Any

import numpy as np

from repro_torch.obs import metrics as M
from repro_torch.obs import trace as T
from repro_torch.streaming.sources import Frame, PacedPlayer
from repro_torch.streaming.tiler import Detection, Tiler

_SENTINEL = None

_STAGES = ("tile", "infer", "aggregate")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Pipeline scheduling knobs.

    `deadline_ms=None` disables deadline drops (sensible for throughput
    runs); `realtime=None` auto-detects — a `PacedPlayer` with a target FPS
    streams in real time (drop policy active), anything else is a
    throughput run (ingest blocks, backpressure reaches the source).
    """
    deadline_ms: float | None = None
    queue_size: int = 4
    drop_policy: str = "newest"            # or "oldest"
    realtime: bool | None = None

    def __post_init__(self):
        if self.drop_policy not in ("newest", "oldest"):
            raise ValueError(f"unknown drop_policy {self.drop_policy!r}")
        if self.queue_size < 1:
            raise ValueError("queue_size must be >= 1")


@dataclasses.dataclass
class _Item:
    frame: Frame
    t_ingest: float
    tiles: np.ndarray | None = None
    positions: list | None = None
    scores: np.ndarray | None = None
    stage_s: dict = dataclasses.field(default_factory=dict)
    span: "T.Span | None" = None           # root "frame" span when traced


@dataclasses.dataclass
class FrameResult:
    """One served frame as the pipeline's client sees it."""
    index: int
    detections: list[Detection]
    t_source: float
    t_ingest: float
    t_done: float
    stage_s: dict

    @property
    def latency_s(self) -> float:
        """Ingest-to-detections wall clock (what the consumer observes)."""
        return self.t_done - self.t_ingest


class StreamingPipeline:
    """Frames -> detections through bounded, deadline-checked stages."""

    def __init__(self, source: Any, engine: Any, tiler: Tiler | None = None,
                 *, config: StreamConfig = StreamConfig()):
        self.source = source
        self.engine = engine
        self.tiler = tiler if tiler is not None else Tiler()
        self.config = config
        self.sweep = bool(getattr(self.tiler, "sweep", False))
        if self.sweep and not (hasattr(engine, "params")
                               and hasattr(engine, "backend")):
            raise TypeError(
                "sweep mode scores whole frames through the engine's model, "
                f"but {type(engine).__name__} exposes no params/backend "
                "(use a VisionEngine, or any object with .params/.backend)")
        # disaggregated engines (serving/disagg.DisaggServer) score whole
        # frames through their own trunk/head pools instead of the tiler's
        # monolithic sweep; they also warm both halves at construction, so
        # the pipeline-side warmup is theirs to skip
        self._disagg = self.sweep and callable(getattr(engine, "score_frame", None))
        # a sweep replays a captured frame graph on the loop's thread; the
        # tiler answers whether the frame has one
        self._inline = self.sweep and not self._disagg
        if self.sweep and not self._disagg and hasattr(source, "frame_shape"):
            # run the whole-frame sweep once BEFORE the clip starts (the
            # VisionEngine warmup idiom): the first call builds the kernels,
            # which would otherwise blow every deadline in realtime mode
            H, W = source.frame_shape
            self._sweep_frame(np.zeros((1, H, W, 1), np.float32))
        # duck-typed engines (tests stub serve(tiles)) may not accept the
        # trace-context kwarg; detect once instead of try/except per wave
        serve = getattr(engine, "serve", None)
        self._serve_takes_span = bool(
            serve is not None
            and "parent_span" in inspect.signature(serve).parameters)
        if config.realtime is not None:
            self.realtime = bool(config.realtime)
        else:
            self.realtime = bool(isinstance(source, PacedPlayer)
                                 and source.fps)
        self.results: list[FrameResult] = []
        # -- registry-backed accounting: counters/gauges/histograms in the
        # process-wide registry (bounded memory; `stats()` reads them back,
        # the Prometheus dump exports them).  One unique instance label per
        # pipeline so concurrent benchmark rows coexist.
        self._id = M.instance_label("pipe")
        reg = M.REGISTRY
        self._m_frames_in = reg.counter("stream_frames_in", pipe=self._id)
        self._m_served = reg.counter("stream_frames_served", pipe=self._id)
        self._m_drops: dict[str, M.Counter] = {}   # "stage/reason" -> Counter
        self._stage_hist = {k: reg.histogram("stream_stage_seconds",
                                             stage=k, pipe=self._id)
                            for k in _STAGES}
        self._lat_hist = reg.histogram("stream_frame_latency_seconds",
                                       pipe=self._id)
        self._m_fps = reg.gauge("stream_achieved_fps", pipe=self._id)
        self._m_thread = {t: reg.counter("stream_infer_thread", pipe=self._id,
                                         thread=t)
                          for t in ("loop", "worker")}
        self._queue_gauges: dict[str, M.Gauge] = {}
        self._t_first: float | None = None
        self._t_last: float | None = None

    # -- accounting ---------------------------------------------------------

    def _drop(self, stage: str, reason: str,
              item: "_Item | None" = None) -> None:
        key = f"{stage}/{reason}"
        c = self._m_drops.get(key)
        if c is None:
            c = M.REGISTRY.counter("stream_frames_dropped", stage=stage,
                                   reason=reason, pipe=self._id)
            self._m_drops[key] = c
        c.inc()
        if item is not None and item.span is not None:
            tr = T.get()
            if tr is not None:
                tr.end(item.span, f"dropped:{key}")
                if reason == "deadline":
                    tr.recorder.trip(
                        "slo_violation",
                        f"frame {item.frame.index} missed its "
                        f"{self.config.deadline_ms} ms deadline at {stage}")
                item.span = None

    def _expired(self, item: _Item, stage: str) -> bool:
        dl = self.config.deadline_ms
        if dl is None:
            return False
        if (time.perf_counter() - item.t_ingest) * 1e3 <= dl:
            return False
        self._drop(stage, "deadline", item)
        return True

    async def _admit(self, q: asyncio.Queue, name: str, item: _Item) -> None:
        """Bounded-queue admission: block in throughput mode, apply the drop
        policy in real-time mode (the camera never waits)."""
        if not self.realtime:
            await q.put(item)
        else:
            try:
                q.put_nowait(item)
            except asyncio.QueueFull:
                if self.config.drop_policy == "oldest":
                    evicted = q.get_nowait()           # evict the stalest
                    q.task_done()
                    self._drop(name, "queue_full", evicted)
                    q.put_nowait(item)
                else:
                    self._drop(name, "queue_full", item)
                    return
        g = self._queue_gauges.get(name)
        if g is None:
            g = M.REGISTRY.gauge("stream_queue_depth", queue=name,
                                 pipe=self._id)
            self._queue_gauges[name] = g
        g.set(q.qsize())

    # -- stages -------------------------------------------------------------

    async def _ingest(self, q_tile: asyncio.Queue) -> None:
        if hasattr(self.source, "__aiter__"):
            async for frame in self.source:
                await self._take(q_tile, frame)
        else:
            for frame in self.source:
                await self._take(q_tile, frame)
                await asyncio.sleep(0)             # let stages run
        await q_tile.put(_SENTINEL)

    async def _take(self, q_tile: asyncio.Queue, frame: Frame) -> None:
        now = time.perf_counter()
        if self._t_first is None:
            self._t_first = now
        self._m_frames_in.inc()
        tr = T.get()
        span = (tr.start("frame", f"frame-{frame.index}",
                         index=frame.index, pipe=self._id)
                if tr is not None else None)
        await self._admit(q_tile, "ingest",
                          _Item(frame=frame, t_ingest=now, span=span))

    async def _tile_stage(self, q_tile: asyncio.Queue,
                          q_infer: asyncio.Queue) -> None:
        tr = T.get()
        while True:
            item = await q_tile.get()
            if item is _SENTINEL:
                await q_infer.put(_SENTINEL)
                return
            if self._expired(item, "tile"):
                continue
            t0 = time.perf_counter()
            child = (tr.start("tile", item.span.trace_id, parent=item.span)
                     if tr is not None and item.span is not None else None)
            item.tiles, item.positions = self.tiler.extract(item.frame)
            if child is not None:
                tr.end(child, n_tiles=len(item.tiles))
            item.stage_s["tile"] = time.perf_counter() - t0
            self._stage_hist["tile"].observe(item.stage_s["tile"])
            await self._admit(q_infer, "tile", item)

    def _sweep_frame(self, frames: np.ndarray, span=None) -> np.ndarray:
        eng = self.engine
        if span is not None:           # a traced frame: its sweep's spans nest under it
            return self.tiler.score(eng.params, frames, backend=eng.backend,
                                    device=getattr(eng, "device", None),
                                    parent_span=span)
        return self.tiler.score(eng.params, frames, backend=eng.backend,
                                device=getattr(eng, "device", None))

    def _replay_wave(self, item: _Item) -> "np.ndarray | None":
        """The frame's sweep as a replay of its captured frame graph, on the
        calling thread (the event loop's); None where it has none."""
        if not self._inline:
            return None
        eng = self.engine
        return self.tiler.replay(eng.params, item.tiles, backend=eng.backend,
                                 device=getattr(eng, "device", None),
                                 parent_span=item.span)

    def _serve_wave(self, item: _Item) -> "np.ndarray | None":
        """One batched wave through the engine (worker thread); in sweep
        mode, one full-frame sweep instead.  The engine's intake stays open
        across waves (continuous batching) and `serve()` pops its own
        results, so the engine's resident state stays O(batch) over an
        unbounded clip.  Returns None when the engine shed any of the
        frame's tiles — a partially-scored frame is a dropped frame; on the
        disaggregated route, None when the server shed the query."""
        eng = self.engine
        if self._disagg:
            try:
                if item.span is not None:
                    return eng.score_frame(item.tiles, parent_span=item.span)
                return eng.score_frame(item.tiles)
            except Exception as e:    # noqa: BLE001 — sheds carry .reason
                # a DisaggShedError (queue_depth / deadline / fault after
                # failover) is the fleet declining the frame, not a bug:
                # surface it as a dropped frame like an engine shed
                if hasattr(e, "reason"):
                    return None
                raise
        if self.sweep:
            return self._sweep_frame(item.tiles, item.span)
        if self._serve_takes_span and item.span is not None:
            res = eng.serve(list(item.tiles), parent_span=item.span)
        else:
            res = eng.serve(list(item.tiles))
        if any(r is None for r in res):
            return None
        return np.stack([r.scores for r in res])

    async def _infer_stage(self, q_infer: asyncio.Queue,
                           q_agg: asyncio.Queue) -> None:
        loop = asyncio.get_running_loop()
        tr = T.get()
        while True:
            item = await q_infer.get()
            if item is _SENTINEL:
                await q_agg.put(_SENTINEL)
                return
            if self._expired(item, "infer"):
                continue
            t0 = time.perf_counter()
            child = (tr.start("infer", item.span.trace_id, parent=item.span,
                              route=("disagg" if self._disagg
                                     else "sweep" if self.sweep
                                     else "engine"))
                     if tr is not None and item.span is not None else None)
            item.scores, thread = self._replay_wave(item), "loop"
            if item.scores is None:
                item.scores, thread = await loop.run_in_executor(
                    None, self._serve_wave, item), "worker"
            self._m_thread[thread].inc()
            if child is not None:
                tr.end(child, "ok" if item.scores is not None else "shed",
                       thread=thread)
            item.stage_s["infer"] = time.perf_counter() - t0
            self._stage_hist["infer"].observe(item.stage_s["infer"])
            if item.scores is None:
                self._drop("infer", "shed", item)  # engine shed >=1 tile
                continue
            await self._admit(q_agg, "infer", item)

    async def _agg_stage(self, q_agg: asyncio.Queue) -> None:
        tr = T.get()
        while True:
            item = await q_agg.get()
            if item is _SENTINEL:
                return
            if self._expired(item, "aggregate"):
                continue
            t0 = time.perf_counter()
            child = (tr.start("aggregate", item.span.trace_id,
                              parent=item.span)
                     if tr is not None and item.span is not None else None)
            dets = self.tiler.aggregate(item.scores, item.positions,
                                        item.tiles)
            if child is not None:
                tr.end(child, n_detections=len(dets))
            t_done = time.perf_counter()
            item.stage_s["aggregate"] = t_done - t0
            self._stage_hist["aggregate"].observe(item.stage_s["aggregate"])
            self._t_last = t_done
            self._m_served.inc()
            self._lat_hist.observe(t_done - item.t_ingest)
            if item.span is not None and tr is not None:
                tr.end(item.span, "served", n_detections=len(dets))
                item.span = None
            self.results.append(FrameResult(
                index=item.frame.index, detections=dets,
                t_source=item.frame.t_source, t_ingest=item.t_ingest,
                t_done=t_done, stage_s=dict(item.stage_s)))

    # -- driving ------------------------------------------------------------

    async def arun(self) -> list[FrameResult]:
        qs = self.config.queue_size
        q_tile, q_infer, q_agg = (asyncio.Queue(maxsize=qs) for _ in range(3))
        await asyncio.gather(self._ingest(q_tile),
                             self._tile_stage(q_tile, q_infer),
                             self._infer_stage(q_infer, q_agg),
                             self._agg_stage(q_agg))
        return self.results

    def run(self) -> list[FrameResult]:
        """Synchronous convenience: drive the whole clip to completion."""
        return asyncio.run(self.arun())

    # -- reporting ----------------------------------------------------------

    def stats(self) -> dict:
        served = self._m_served.value
        frames_in = self._m_frames_in.value
        drops = {k: c.value for k, c in sorted(self._m_drops.items())}
        dropped = sum(drops.values())
        wall = ((self._t_last or 0.0) - (self._t_first or 0.0)
                if served else 0.0)
        by_reason: dict[str, int] = {}
        for key, n in drops.items():
            reason = key.split("/", 1)[1]
            by_reason[reason] = by_reason.get(reason, 0) + n
        accounted = frames_in == served + dropped
        fps = served / wall if wall > 0 else 0.0
        self._m_fps.set(fps)
        lat = self._lat_hist.summary_ms()
        out = {
            "mode": "realtime" if self.realtime else "throughput",
            "frames_in": frames_in,
            "frames_served": served,
            "frames_dropped": dropped,
            "drop_rate": dropped / frames_in if frames_in else 0.0,
            "drops_by_stage": drops,
            "drops_by_reason": by_reason,
            # the no-silent-loss invariant; CI smoke asserts it
            "accounted": accounted,
            "sustained_fps": fps,
            "detections_total": sum(len(r.detections) for r in self.results),
            "infer_thread": {t: c.value for t, c in self._m_thread.items()},
            "queue_hwm": {k: int(g.hwm)
                          for k, g in self._queue_gauges.items()},
            "stage": {k: h.summary_ms()
                      for k, h in self._stage_hist.items()},
            **{f"latency_{k}": v for k, v in lat.items() if k != "n"},
        }
        if not accounted:
            tr = T.get()
            if tr is not None:
                tr.recorder.trip(
                    "ledger_invariant",
                    f"pipeline {self._id}: frames_in={frames_in} != "
                    f"served={served} + dropped={dropped}")
        if hasattr(self.engine, "stats"):
            es = self.engine.stats()
            out["engine"] = es
            if "batch_occupancy" in es:
                out["batch_occupancy"] = es["batch_occupancy"]
            elif "per_replica" in es:
                # exact fleet occupancy: total real images / total slots
                # (NOT a mean of per-replica ratios, which overweights
                # busy replicas)
                slots = sum(r["batches"] * r["batch_size"]
                            for r in es["per_replica"] if "batches" in r)
                padded = sum(r["padded_slots"] for r in es["per_replica"]
                             if "padded_slots" in r)
                if slots:
                    out["batch_occupancy"] = (slots - padded) / slots
        return out
