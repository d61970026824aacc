from repro_torch.kernels.sigmoid_pla.ops import sigmoid_pla, sigmoid_pla_plain  # noqa: F401
