from repro_torch.kernels.frame_trunk.ops import (  # noqa: F401
    HALO, check_frame_geometry, choose_tile, frame_trunk_quad,
    frame_trunk_quad_plain)
