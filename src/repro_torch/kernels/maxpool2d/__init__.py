from repro_torch.kernels.maxpool2d.ops import maxpool2d, maxpool2d_plain  # noqa: F401
