from repro_torch.kernels.conv2d.ops import conv2d, conv2d_plain  # noqa: F401
