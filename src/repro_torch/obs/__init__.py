"""Runtime observability: spans, metrics, and the flight recorder (port of
`repro.obs`, pure Python apart from the torch.profiler bridge)."""
from repro_torch.obs import metrics, recorder, trace  # noqa: F401
