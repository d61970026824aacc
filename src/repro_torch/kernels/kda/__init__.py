from repro_torch.kernels.kda.ops import (  # noqa: F401
    CHUNK, kda_chunk_prefill, kda_chunk_prefill_plain, kda_decode_step, kda_decode_step_plain)
