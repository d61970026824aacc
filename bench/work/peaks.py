"""Peak rates of the card, the denominators of every roofline and MFU.

NVIDIA H100 SXM5 data sheet, dense rates at the 700 W limit: float32 67
TFLOP/s on the CUDA cores, HBM3 3.35 TB/s.  int32 is not on the sheet: it
is derived, 132 SMs x 64 INT32 lanes x 1.98 GHz boost clock = 16.7 Tops/s
(one operation a lane a clock, the clock behind the sheet's float32 rate).
A card that is not an H100 has no entry, and asking for one raises.
"""
from __future__ import annotations

PEAKS = {
    "H100": {"float32": 67e12, "int32": 132 * 64 * 1.98e9, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> dict:
    for kind, peaks in PEAKS.items():
        if kind.lower() in device_name.lower():
            return peaks
    raise KeyError(f"no peak rates for {device_name!r}; known: {sorted(PEAKS)}")


def bound_s(nbytes: float, ops: float, dtype: str, peaks: dict) -> float:
    """The least time of a call: the larger of its bytes over the memory's
    rate and its operations over the type's peak."""
    return max(nbytes / peaks["hbm_bytes_per_s"], ops / peaks[dtype])
