"""Real-time streaming vision on the port: frame sources -> sliding-window
tiler or full-frame sweep -> deadline-scheduled pipeline over `VisionEngine`.

Port of `repro.streaming`: seeded synthetic video sources (`sources`), the
host sliding-window tiler (`tiler`), the fully-convolutional frame sweep
that runs the trunk once per frame and scores every window from the pooled
feature map (`fcn_sweep`, word-exact with the tiler on the fixed backends),
and the asyncio pipeline with bounded queues, backpressure and per-frame
deadlines (`pipeline`).
"""
from repro_torch.streaming.fcn_sweep import FcnSweep  # noqa: F401
from repro_torch.streaming.pipeline import StreamConfig, StreamingPipeline  # noqa: F401
from repro_torch.streaming.sources import (Frame, PacedPlayer,  # noqa: F401
                                           SyntheticVideoSource)
from repro_torch.streaming.tiler import Detection, Tiler  # noqa: F401
