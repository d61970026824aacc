"""MFU + bytes-moved accounting for smallNet's hot paths on the port.

Port of `repro.analysis.mfu` (pure Python; the port keeps its own copy).
It supplies the two halves of an efficiency account:

  1. a DEVICE DATABASE (`DEVICE_DB`): per-dtype peak rates + memory
     bandwidth for the CPU and the H100, the one card the port runs on
     (another card raises until its entry is added) — the achievable-FLOPs
     denominator.  Lookups are TOTAL: an unknown device raises with the
     known-device list (silent zeros would quietly report MFU=inf or 0),
     and a CPU tensor's device always resolves to the generic "cpu" entry
     (`resolve`).  The "h100" entry is the ONE definition of the card's
     peaks: `chip_smoke.py`'s kernel bounds read it.  A torch process
     cannot run on a TPU, so the port lists none.  An entry may carry
     `link_bw`, the bytes a second a device sends on its interconnect, the
     denominator of a roofline's collective term (`analysis/roofline.py`);
     asking an entry without one for it raises (`DeviceSpec.link`).

  2. an ANALYTIC WORKLOAD MODEL (`trunk_workload` / `sweep_workload` /
     `tiler_workload` / `deployed_workload`): model FLOPs and bytes moved
     per frame for each route — the host tiler, the composed quad-cascade
     sweep, and the `csrc/frame_trunk.cu` kernel (whose input bytes are
     the words its blocks really read, via the port's `choose_tile`, and
     whose operations are `frame_trunk_work`'s, the one count of that
     launch's work: `chip_smoke.py`'s bound for the kernel reads it too).

MFU numerator convention: MODEL FLOPs — 2 flops per multiply-accumulate of
the convs and dense layers the route's algorithm specifies, padding taps
included (the datapath multiplies them against real zero operands),
activations / bias adds / pool comparisons excluded.  The one exception is
the one-launch trunk (`sweep_megakernel`): its count is the operations the
kernel must do at the least (`frame_trunk_work`), so that the kernel's
roofline and its bound are one account.  The kernels are
opaque to torch's FLOP counter, and the plain conv is elementwise, which
is why the numerator is analytic; `tests/test_torch_mfu.py` holds it
against `torch.utils.flop_counter` over `F.conv2d`/`F.linear` of the same
shapes, an independent count of the same MACs.

Bytes-moved convention: off-chip traffic between kernel launches.  The
composed sweep round-trips every intermediate role map through HBM (each
launch reads its inputs and writes its outputs); the one-launch trunk
moves only its staged input tiles in and the pooled quad out.

MFU clock convention (`mfu_clock`): on the card, the measured time of the
route's kernels; where the plain versions run (a CPU tensor), the roofline
floor `modeled_seconds`.  Every row records which basis produced its mfu.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

# ---------------------------------------------------------------------------
# Device database
# ---------------------------------------------------------------------------

DTYPE_CLASSES = ("f32", "bf16", "f16", "int8", "int32")


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """Peak rates for one device: FLOP/s (or integer op/s) per dtype class
    + HBM/DRAM bandwidth in bytes/s, and where it has one, the bytes a
    second it sends on its interconnect (`link_bw`).  `kinds` are
    substrings matched (case-insensitive) against
    `torch.cuda.get_device_name` by `lookup`."""
    name: str
    kinds: tuple[str, ...]
    peak_flops: Mapping[str, float]
    mem_bw: float
    source: str
    link_bw: float | None = None

    def peak(self, dtype: str) -> float:
        if dtype not in self.peak_flops:
            raise KeyError(
                f"device {self.name!r} has no peak for dtype class "
                f"{dtype!r}; known: {sorted(self.peak_flops)}")
        return self.peak_flops[dtype]

    def link(self) -> float:
        """The interconnect's bytes a second, one direction; raises for a
        device without one, as `lookup` raises for an unknown device (a
        collective term over a guessed link is worse than none)."""
        if not self.link_bw:
            raise KeyError(f"device {self.name!r} has no link bandwidth: a "
                           f"collective term needs one (add link_bw to its "
                           f"DeviceSpec in analysis/mfu.py)")
        return self.link_bw


def _spec(name, kinds, f32, bf16, f16, i8, i32, bw, source, link_bw=None):
    return DeviceSpec(name, kinds,
                      {"f32": f32, "bf16": bf16, "f16": f16,
                       "int8": i8, "int32": i32}, bw, source, link_bw)


# Vendor-nameplate peaks where published; derived or estimated rates are
# flagged per entry.
DEVICE_DB: dict[str, DeviceSpec] = {s.name: s for s in [
    _spec("cpu", ("cpu",),
          2.5e12, 2.5e12, 2.5e12, 5.0e12, 1.2e12, 1.0e11,
          "generic AVX-512 server estimate (16c x 2 FMA x 16 lanes); the "
          "entry for CPU tensors, where the plain versions run"),
    # int32 runs on an SM's 64 INT32 lanes, one operation a lane a clock,
    # at the 1.98 GHz boost clock behind the data sheet's 67 TFLOP/s fp32
    # (132 SMs x 128 fp32 lanes x 2 x 1.98e9): derived, not on the sheet.
    # The link is NVLink 4 within one node (eight cards); a mesh of 256
    # cards spans nodes, whose network is slower, so a collective term over
    # this link is a lower bound
    _spec("h100", ("H100",),
          67e12, 989e12, 989e12, 1979e12, 132 * 64 * 1.98e9, 3.35e12,
          "H100 SXM5 datasheet, dense: fp32 67 TFLOP/s on the CUDA cores, "
          "bf16/fp16 989 and int8 1,979 TOP/s on the tensor cores, HBM3 "
          "3.35 TB/s; int32 derived: 132 SMs x 64 INT32 lanes x 1.98 GHz "
          "boost = 16.7 Tops/s (the reference's 33.5e12 is an unsourced "
          "estimate); link: NVLink 4, 900 GB/s total a GPU, 450 GB/s a "
          "direction (within a node)",
          link_bw=450e9),
]}


def lookup(device_kind: str) -> DeviceSpec:
    """Total device lookup: exact DB key, then case-insensitive substring
    match on each entry's `kinds`.  Unknown devices raise LOUDLY — an MFU
    against a silently-guessed peak is worse than no MFU."""
    if device_kind in DEVICE_DB:
        return DEVICE_DB[device_kind]
    dk = device_kind.lower()
    # longest kind pattern wins, so a longer alias of one device is never
    # shadowed by a shorter alias of another
    best = None
    for spec in DEVICE_DB.values():
        for kind in spec.kinds:
            if kind.lower() in dk and (best is None or len(kind) > best[0]):
                best = (len(kind), spec)
    if best is not None:
        return best[1]
    raise KeyError(
        f"unknown device kind {device_kind!r}: not in the MFU device "
        f"database (known: {sorted(DEVICE_DB)}).  Add a DeviceSpec with "
        f"its per-dtype peaks to analysis/mfu.py — do not let MFU divide "
        f"by a guess.")


def resolve(device=None) -> tuple[DeviceSpec, bool]:
    """(spec, plain) for a torch device: `device=None` is the port's
    default, "cuda" (raising where there is no CUDA, as every entry point
    does).  A CUDA device resolves through `torch.cuda.get_device_name`;
    a CPU device always resolves to the generic "cpu" entry, where `plain`
    is True: on CPU tensors every kernel wrapper runs its plain version.
    The port has no interpret mode."""
    import torch

    from repro_torch.core.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cpu":
        return DEVICE_DB["cpu"], True
    if dev.type != "cuda":
        raise KeyError(f"no MFU device entry for torch device {str(dev)!r}")
    return lookup(torch.cuda.get_device_name(dev)), False


# backend name -> (dtype class for the peak denominator, bytes per word
# moved off-chip).  Every registered smallnet backend moves 4-byte words:
# float32 activations or int32 Qm.n words (the int8 backend keeps f32
# activations; only its dense MAC runs int8).
BACKEND_NUMERICS: dict[str, tuple[str, int]] = {
    "ref": ("f32", 4), "plan": ("f32", 4),
    "cuda": ("f32", 4), "cuda_plan": ("f32", 4),
    "fixed": ("int32", 4), "fixed_cuda": ("int32", 4),
    "int8": ("int8", 4),
}


def backend_numerics(backend: str) -> tuple[str, int]:
    if backend not in BACKEND_NUMERICS:
        raise KeyError(
            f"backend {backend!r} has no MFU numerics entry "
            f"(known: {sorted(BACKEND_NUMERICS)})")
    return BACKEND_NUMERICS[backend]


# ---------------------------------------------------------------------------
# Analytic workload model
# ---------------------------------------------------------------------------

PATCH = 28                 # the deployed window side
_HEAD_IN, _HEAD_OUT = 49, 10
_TRUNK_PARAM_WORDS = 10    # 2 convs x (4 taps + 1 bias)
_HEAD_PARAM_WORDS = _HEAD_IN * _HEAD_OUT + _HEAD_OUT
PARAM_WORDS = _TRUNK_PARAM_WORDS + _HEAD_PARAM_WORDS          # 510

# quad-cascade tap counts (streaming/fcn_sweep.py `_sweep_stage`): live
# taps of each masked conv, i.e. the MACs the algorithm specifies
_L0_TAPS = 4 + 2 + 2 + 1             # s_ii + s_li + s_il + s_ll
_L1_TAPS = _L0_TAPS + (4 + 4 + 4 + 2 + 2)   # + s_pi s_ip s_pp s_pl s_lp
# columns a `frame_trunk` block stages past its tile: the 3-word halo,
# padded to a whole 16-byte vector
_ROW_PAD = 4


@dataclasses.dataclass(frozen=True)
class Workload:
    """Model FLOPs + off-chip bytes for one route over one frame.  Bytes
    are split so scaling laws stay exact: `bytes_params` is the constant
    weight traffic (counted once per frame), everything else scales with
    the frame."""
    name: str
    flops: int
    bytes_in: int
    bytes_out: int
    bytes_params: int

    @property
    def bytes_total(self) -> int:
        return self.bytes_in + self.bytes_out + self.bytes_params

    @property
    def intensity(self) -> float:
        """Arithmetic intensity, FLOPs per byte moved."""
        return self.flops / max(self.bytes_total, 1)

    def __add__(self, other: "Workload") -> "Workload":
        return Workload(f"{self.name}+{other.name}",
                        self.flops + other.flops,
                        self.bytes_in + other.bytes_in,
                        self.bytes_out + other.bytes_out,
                        self.bytes_params + other.bytes_params)


def _conv_flops(h: int, w: int, taps: int) -> int:
    """2 flops per MAC, `taps` MACs per output position."""
    return 2 * taps * h * w


def deployed_workload(word_bytes: int = 4) -> Workload:
    """One 28x28 image through `smallnet.apply`: conv1 over 28x28 SAME (4
    taps), conv2 over 14x14, dense 49->10.  The hand-countable unit cell:
    2*(4*784 + 4*196 + 490) = 8820 model FLOPs."""
    flops = (_conv_flops(PATCH, PATCH, 4)
             + _conv_flops(PATCH // 2, PATCH // 2, 4)
             + 2 * _HEAD_IN * _HEAD_OUT)
    return Workload("deployed", flops,
                    bytes_in=PATCH * PATCH * word_bytes,
                    bytes_out=_HEAD_OUT * word_bytes,
                    bytes_params=PARAM_WORDS * word_bytes)


def frame_trunk_work(H: int, W: int) -> tuple[int, int]:
    """(bytes, integer operations) that the whole trunk of one (H, W) frame
    needs at the least.  Bytes: each input word read once (the H*W frame
    and the ten tap and bias words; the halo's zeros are made, not read),
    each output word written once.  Operations: only the words that the
    two pools read, counting one per product of a word and a tap (a
    product that several masked convs share, once), one per add (a tap sum
    that is a part of another at the same position, once), one per bias or
    recombination fixed_add (the zero word's not at all), one per PLAN
    word and one per max of two words.  Per level-2 position, i.e. per 4x4
    block of frame pixels:
      level 0: 64 products, 49 tap-sum adds, 25 words (a bias add and a
               PLAN each), 23 maxes (I at all four level-1 positions, B on
               the odd row, R on the odd column, C at odd/odd)     = 186
      level 1: 36 products, 46 adds, 16 PLAN words, 12 maxes      = 110
    So 18.5 operations per frame pixel against 5 bytes: bound by bytes."""
    blocks = (H // 4) * (W // 4)
    nbytes = 4 * H * W + 4 * _TRUNK_PARAM_WORDS + 4 * 4 * blocks
    return nbytes, (186 + 110) * blocks


def trunk_workload(H: int, W: int, route: str = "trunk",
                   word_bytes: int = 4) -> Workload:
    """Model FLOPs + bytes for the conv trunk over one HxW frame.

    route="trunk":  the plain two-stage trunk (`smallnet.conv_trunk`'s
        interior map), perfectly fused: read the frame once, write the
        pooled H/4 x W/4 map once.  This is the roofline IDEAL every
        sweep route is measured against.
    route="sweep_composed":  the quad role-map cascade of
        `fcn_sweep._sweep_stage` — 4 masked convs at level 0 (9 live taps
        per pixel) and 4 single- + 5 mixed-source maps at level 1 (25
        live taps), with every intermediate map round-tripping HBM
        between launches (convs, PLAN units, accumulates, pools).
    route="sweep_megakernel":  the same quad maps computed inside the
        `csrc/frame_trunk.cu` kernel's tiles, via the port's own
        `choose_tile`: its operations are `frame_trunk_work`'s (18.5 a
        pixel, products shared between masked convs counted once, biases,
        PLAN words and pool maxes included), and the only off-chip traffic
        is the words each block reads into shared memory and the pooled
        quad out.
        A block stages (th+HALO) x (tw+4) words, the tile plus its
        bottom/right halo with a row padded to whole 16-byte vectors;
        words past the frame's edge are made as zeros, not read.  So the
        words read are, over tile rows and tile columns,
        sum_i min(th+HALO, H-i*th) x sum_j min(tw+4, W-j*tw).
    """
    A = H * W
    w = word_bytes
    if route == "trunk":
        flops = _conv_flops(H, W, 4) + _conv_flops(H // 2, W // 2, 4)
        return Workload("trunk", flops, A * w, (A // 16) * w,
                        _TRUNK_PARAM_WORDS * w)
    if route == "sweep_composed":
        a = A // 4
        flops = 2 * _L0_TAPS * A + 2 * _L1_TAPS * a
        # per-launch HBM round-trips (elements):
        #   level 0: 4 convs read the frame (4A), 3 PLAN units re-read the
        #   un-fused conv outs (3A), pools read interior A + mix 2A +
        #   last-col 2A + corner 4A = 9A -> 16A read;
        #   writes: 4 conv outs + 3 PLAN outs + pooled quad A -> 8A
        #   level 1 (maps of a = A/4 elements): 16 conv launches (4 single
        #   + 12 masked partials) read 16a, 7 accumulate adds read 14a,
        #   8 PLAN units read 8a, pools read 9a -> 47a read;
        #   writes: 16a conv + 7a add + 8a PLAN + a pooled quad -> 32a
        reads = 16 * A + 47 * a
        writes = 8 * A + 32 * a
        return Workload("sweep_composed", flops, reads * w, writes * w,
                        _TRUNK_PARAM_WORDS * w)
    if route == "sweep_megakernel":
        from repro_torch.kernels.frame_trunk.ops import HALO, choose_tile
        th, tw = choose_tile(H, W)
        _, flops = frame_trunk_work(H, W)
        rows = sum(min(th + HALO, H - i) for i in range(0, H, th))
        cols = sum(min(tw + _ROW_PAD, W - j) for j in range(0, W, tw))
        quad_out = 4 * (H // 4) * (W // 4)
        return Workload("sweep_megakernel", flops, rows * cols * w,
                        quad_out * w, _TRUNK_PARAM_WORDS * w)
    raise ValueError(
        f"unknown trunk route {route!r} "
        f"(known: trunk, sweep_composed, sweep_megakernel)")


def head_workload(n_windows: int, word_bytes: int = 4) -> Workload:
    """The windowed dense head: gather 49 pooled features per window, one
    49->10 MAC per window."""
    w = word_bytes
    return Workload("head", 2 * _HEAD_IN * _HEAD_OUT * n_windows,
                    n_windows * _HEAD_IN * w, n_windows * _HEAD_OUT * w,
                    _HEAD_PARAM_WORDS * w)


def sweep_workload(H: int, W: int, n_windows: int, route: str,
                   word_bytes: int = 4) -> Workload:
    """The full FcnSweep per-frame program: trunk (composed or megakernel
    route) + windowed dense head."""
    return (trunk_workload(H, W, route, word_bytes)
            + head_workload(n_windows, word_bytes))


def tiler_workload(n_windows: int, word_bytes: int = 4) -> Workload:
    """The host-tiler route: every window re-runs the full 28x28 deployed
    network, and every window's 784 pixels are re-read from the frame —
    overlapping windows re-convolve (and re-move) shared pixels, which is
    exactly what the sweep exists to avoid."""
    d = deployed_workload(word_bytes)
    return Workload("tiler", d.flops * n_windows,
                    d.bytes_in * n_windows, d.bytes_out * n_windows,
                    PARAM_WORDS * word_bytes)


ROUTE_WORKLOADS = ("tiler", "sweep_composed", "sweep_megakernel")


def route_workload(route: str, H: int, W: int, n_windows: int,
                   word_bytes: int = 4) -> Workload:
    """The perf-ledger entry point: one Workload per (route, geometry)."""
    if route == "tiler":
        return tiler_workload(n_windows, word_bytes)
    if route in ("sweep_composed", "sweep_megakernel"):
        return sweep_workload(H, W, n_windows, route, word_bytes)
    raise ValueError(f"unknown ledger route {route!r} "
                     f"(known: {ROUTE_WORKLOADS})")


# ---------------------------------------------------------------------------
# Achieved rates, MFU, roofline terms
# ---------------------------------------------------------------------------

def achieved(workload: Workload, seconds: float) -> dict:
    """Measured rates for one frame of `workload` computed in `seconds`."""
    if not seconds > 0:
        raise ValueError(f"achieved() needs a positive duration, got "
                         f"{seconds!r}")
    return {"achieved_flops": workload.flops / seconds,
            "achieved_bw": workload.bytes_total / seconds}


def mfu(workload: Workload, seconds: float, *, device: DeviceSpec,
        dtype: str) -> float:
    """Model-FLOPs utilization: (model FLOPs / wall seconds) / peak FLOP/s
    of the device at the backend's dtype class.  By construction in (0, 1]
    for any real measurement — a value outside that range means the
    workload model or the device entry is wrong, and the ledger gate
    treats it as a failure, not a triumph."""
    return achieved(workload, seconds)["achieved_flops"] / device.peak(dtype)


def modeled_seconds(workload: Workload, *, device: DeviceSpec,
                    dtype: str) -> float:
    """Roofline floor time for one frame: max(compute floor, memory floor).
    This is the MFU clock where the plain versions run: on a CPU tensor
    every kernel wrapper runs its plain PyTorch version, so wall time
    measures those host ops, not the kernel the workload describes.  The
    roofline floor is deterministic and machine-independent; on the card
    the measured clock is used instead (`mfu_clock`)."""
    t = roofline_terms(workload, device=device, dtype=dtype)
    return max(t["compute_s"], t["memory_s"])


def mfu_clock(workload: Workload, measured_s: float, *, device: DeviceSpec,
              dtype: str, plain: bool) -> tuple[float, str]:
    """(seconds, basis) the MFU/achieved-rate columns divide by: the
    measured kernel time on the card, the roofline floor
    (`modeled_seconds`) where the plain versions run (`resolve`'s
    `plain`).  The basis string ("measured" / "roofline_model") goes next
    to every mfu value so a row can never be misread as a measurement."""
    if plain:
        return modeled_seconds(workload, device=device, dtype=dtype), \
            "roofline_model"
    return measured_s, "measured"


def roofline_terms(workload: Workload, *, device: DeviceSpec,
                   dtype: str) -> dict:
    """Two-term roofline for one frame: compute floor, memory floor, the
    binding term, and the attainable FLOP/s at this arithmetic intensity
    (min(peak, intensity * bw) — the classic roofline ceiling)."""
    peak = device.peak(dtype)
    compute_s = workload.flops / peak
    memory_s = workload.bytes_total / device.mem_bw
    return {
        "flops": workload.flops,
        "bytes": workload.bytes_total,
        "intensity": workload.intensity,
        "compute_s": compute_s,
        "memory_s": memory_s,
        "bound": "compute" if compute_s >= memory_s else "memory",
        "attainable_flops": min(peak, workload.intensity * device.mem_bw),
        "peak_flops": peak,
        "mem_bw": device.mem_bw,
        "device": device.name,
        "dtype": dtype,
    }
