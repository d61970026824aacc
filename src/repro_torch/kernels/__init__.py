"""Hand-written CUDA kernels (sources in `repro_torch/csrc/`) with their
plain PyTorch versions; `launches()` / `reset_launches()` read and clear the
per-kernel launch counts."""
from repro_torch.kernels._launch import launches, reset_launches
