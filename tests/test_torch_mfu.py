"""The port's measurement modules (`repro_torch.analysis`) against the
reference's `repro.analysis`.

`mfu`: every analytic workload equals the reference's for the same
arguments, except the one-launch trunk's, which follows the port's own
kernel (`csrc/frame_trunk.cu`): its bytes are pinned here to a hand count
of the tiles from its `choose_tile`, its operations to `frame_trunk_work`,
the count the kernel's bound uses; the model's FLOPs equal an independent
count of the same MACs by `torch.utils.flop_counter` over `F.conv2d` /
`F.linear` of the same shapes; the device database holds the CPU and the
H100 only, and its "h100" entry is the card's one set of peaks.
`launches`: the kernel-name matching on synthetic profiler event lists, and
the table covers every kernel of `csrc/`.  The card test (the profiler's
count against the wrappers') skips without CUDA.
"""
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro.analysis import mfu as jmfu  # noqa: E402
from repro_torch.analysis import launches as L  # noqa: E402
from repro_torch.analysis import mfu  # noqa: E402
from repro_torch.analysis.mfu import (BACKEND_NUMERICS, DEVICE_DB,  # noqa: E402
                                      DTYPE_CLASSES, Workload, backend_numerics,
                                      lookup, mfu_clock, modeled_seconds, resolve,
                                      route_workload, trunk_workload)

CSRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
SHAPES = ((28, 28), (112, 112), (104, 132), (512, 512), (1080, 1920))


# ---------------------------------------------------------------------------
# the workload model against the reference's
# ---------------------------------------------------------------------------

def _same(a, b):
    return (a.name, a.flops, a.bytes_in, a.bytes_out, a.bytes_params) == \
        (b.name, b.flops, b.bytes_in, b.bytes_out, b.bytes_params)


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("word_bytes", [4, 1])
def test_workloads_equal_the_reference(H, W, word_bytes):
    for route in ("trunk", "sweep_composed"):
        assert _same(trunk_workload(H, W, route, word_bytes),
                     jmfu.trunk_workload(H, W, route, word_bytes))
    n = (H // 4) * (W // 4)
    assert _same(mfu.head_workload(n, word_bytes), jmfu.head_workload(n, word_bytes))
    assert _same(mfu.tiler_workload(n, word_bytes), jmfu.tiler_workload(n, word_bytes))
    assert _same(mfu.deployed_workload(word_bytes), jmfu.deployed_workload(word_bytes))
    for route in ("tiler", "sweep_composed"):
        assert _same(route_workload(route, H, W, n, word_bytes),
                     jmfu.route_workload(route, H, W, n, word_bytes))
    # the one-launch trunk: the kernel's own operations, 186 + 110 a 4x4 block
    mega = trunk_workload(H, W, "sweep_megakernel", word_bytes)
    assert mega.flops == (186 + 110) * (H // 4) * (W // 4)
    assert mega.bytes_out == 4 * (H // 4) * (W // 4) * word_bytes
    assert mega.bytes_params == 10 * word_bytes
    with pytest.raises(ValueError, match="unknown trunk route"):
        trunk_workload(H, W, "sweep_pallas")


@pytest.mark.parametrize("H,W,tile,rows,cols", [
    # 112x112 runs as 392 tiles of 4x8: 27 tile rows stage 4+3 rows, the last
    # one the frame's last 4; 13 tile columns stage 8+4 columns, the last 8
    (112, 112, (4, 8), 27 * 7 + 4, 13 * 12 + 8),
    # 1080x1920 as 648 tiles of 40x80: 26 x 43 + 40 rows, 23 x 84 + 80 columns
    (1080, 1920, (40, 80), 26 * 43 + 40, 23 * 84 + 80),
])
def test_megakernel_bytes_are_the_words_its_blocks_read(H, W, tile, rows, cols):
    from repro_torch.kernels.frame_trunk.ops import choose_tile
    assert choose_tile(H, W) == tile
    wl = trunk_workload(H, W, "sweep_megakernel")
    assert wl.bytes_in == rows * cols * 4
    assert (H // tile[0]) * (W // tile[1]) == {112: 392, 1080: 648}[H]


def test_deployed_workload_hand_count():
    wl = mfu.deployed_workload()
    assert wl.flops == 2 * (4 * 784 + 4 * 196 + 49 * 10) == 8820
    assert wl.bytes_in == 784 * 4
    assert wl.bytes_out == 10 * 4
    assert wl.bytes_params == 510 * 4


def test_megakernel_bytes_bracketed():
    """The one-launch trunk reads more than the fused ideal (halo rows and
    columns at tile seams) and far less than the per-window tiler."""
    for H, n_windows in ((112, 144), (512, 3844)):
        ideal = trunk_workload(H, H, "trunk")
        mega = trunk_workload(H, H, "sweep_megakernel")
        tiler = mfu.tiler_workload(n_windows)
        assert ideal.bytes_in < mega.bytes_in < tiler.bytes_in
        # the kernel shares products between masked convs; the cascade cannot
        assert mega.flops < trunk_workload(H, H, "sweep_composed").flops


@pytest.mark.parametrize("H,W", SHAPES)
def test_frame_trunk_work_is_the_kernels_one_count(H, W):
    """One count of the frame_trunk launch's work: 5 bytes and 18.5
    operations a pixel at the least, which the kernel's roofline reads
    (with the halo re-reads its blocks add) and its bound reads as is."""
    nbytes, ops = mfu.frame_trunk_work(H, W)
    assert nbytes == 5 * H * W + 40 and ops * 2 == 37 * H * W
    mega = trunk_workload(H, W, "sweep_megakernel")
    assert mega.flops == ops
    assert mega.bytes_in + mega.bytes_out + mega.bytes_params >= nbytes
    if (H, W) == (1080, 1920):
        h = DEVICE_DB["h100"]
        assert nbytes / h.mem_bw > ops / h.peak("int32")          # bound by bytes
        assert round(nbytes / h.mem_bw * 1e6, 2) == 3.09          # us, the kernel table's
        assert mfu.roofline_terms(mega, device=h, dtype="int32")["bound"] == "memory"


# ---------------------------------------------------------------------------
# FLOPs: an independent count of the same MACs by torch's FLOP counter
# ---------------------------------------------------------------------------

def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _conv(x, kh, kw):
    """A conv whose kernel is one masked 2x2 conv's live taps: (kh, kw)."""
    return F.conv2d(x, torch.ones(1, 1, kh, kw))


@pytest.mark.parametrize("H,W", [(28, 28), (112, 112), (104, 132)])
def test_model_flops_equal_torch_flop_counter(H, W):
    frame = torch.zeros(1, 1, H, W)
    half = torch.zeros(1, 1, H // 2, W // 2)
    padded = lambda x: F.pad(x, (0, 1, 0, 1))          # SAME: zero after
    # the fused ideal: two 2x2 SAME convs
    assert _counted(lambda: (F.conv2d(padded(frame), torch.ones(1, 1, 2, 2)),
                             F.conv2d(padded(half), torch.ones(1, 1, 2, 2)))) == \
        trunk_workload(H, W, "trunk").flops
    # the quad cascade: each masked conv as a conv over its live taps
    # (2x2 all, 1x2 a row, 2x1 a column, 1x1 a corner), level 0 over the
    # frame, level 1 over the quarter-area maps
    level0 = [(2, 2), (1, 2), (2, 1), (1, 1)]                 # s_ii s_li s_il s_ll
    level1 = level0 + [(1, 2), (1, 2), (2, 1), (2, 1),        # s_pi, s_ip
                       (1, 1), (1, 1), (1, 1), (1, 1),        # s_pp
                       (1, 1), (1, 1), (1, 1), (1, 1)]        # s_pl, s_lp
    same = lambda x, kh, kw: F.pad(x, (0, kw - 1, 0, kh - 1))
    assert _counted(lambda: ([_conv(same(frame, *k), *k) for k in level0],
                             [_conv(same(half, *k), *k) for k in level1])) == \
        trunk_workload(H, W, "sweep_composed").flops
    # the dense head over a frame's windows, and the deployed 28x28 cell
    n = (H // 4) * (W // 4)
    assert _counted(lambda: F.linear(torch.zeros(n, 49), torch.zeros(10, 49))) == \
        mfu.head_workload(n).flops
    img = torch.zeros(1, 1, 28, 28)
    assert _counted(lambda: (F.conv2d(padded(img), torch.ones(1, 1, 2, 2)),
                             F.conv2d(padded(torch.zeros(1, 1, 14, 14)), torch.ones(1, 1, 2, 2)),
                             F.linear(torch.zeros(1, 49), torch.zeros(10, 49)))) == \
        mfu.deployed_workload().flops


# ---------------------------------------------------------------------------
# device database
# ---------------------------------------------------------------------------

def test_lookup_is_total_and_knows_the_card():
    with pytest.raises(KeyError, match="unknown device kind"):
        lookup("quantum-abacus-9000")
    assert lookup("NVIDIA H100 80GB HBM3").name == "h100"
    assert lookup("h100").name == "h100"                          # exact key
    with pytest.raises(KeyError, match="unknown device kind"):    # no entry yet
        lookup("NVIDIA A100-SXM4-80GB")
    with pytest.raises(KeyError, match="no peak for dtype"):
        DEVICE_DB["cpu"].peak("fp4")


@pytest.mark.parametrize("kind", ["TPU v5 lite", "TPU v4", "tpu-v5e", "TPU v6e"])
def test_a_tpu_kind_raises(kind):
    assert jmfu.lookup(kind).name.startswith("tpu")     # the reference knows it
    with pytest.raises(KeyError, match="unknown device kind"):
        lookup(kind)


def test_database_holds_the_cpu_and_nvidia_cards_only():
    assert set(DEVICE_DB) == {"cpu", "h100"}
    for spec in DEVICE_DB.values():
        for dt in DTYPE_CLASSES:
            assert spec.peak(dt) > 0
        assert spec.mem_bw > 0
        if spec.name != "h100":      # the reference's rates, the CPU's note reworded
            ref = jmfu.DEVICE_DB[spec.name]
            assert (spec.kinds, dict(spec.peak_flops), spec.mem_bw) == \
                (ref.kinds, dict(ref.peak_flops), ref.mem_bw)


def test_h100_entry_is_the_cards_one_set_of_peaks():
    h = DEVICE_DB["h100"]
    assert h.mem_bw == 3.35e12
    assert h.peak("f32") == 67e12 and h.peak("int8") == 1979e12
    assert h.peak("int32") == 132 * 64 * 1.98e9
    assert "132 SMs x 64 INT32 lanes x 1.98 GHz" in h.source


def test_resolve_cpu_runs_the_plain_versions():
    spec, plain = resolve("cpu")
    assert spec.name == "cpu" and plain is True
    assert resolve(torch.device("cpu")) == (spec, True)


def test_resolve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the default device resolves")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve()


def test_backend_numerics_name_the_ports_backends():
    assert set(BACKEND_NUMERICS) == {"ref", "plan", "cuda", "cuda_plan", "fixed",
                                     "fixed_cuda", "int8"}
    from repro_torch.core import backends as TB
    assert set(BACKEND_NUMERICS) == set(TB.list_backends())
    assert backend_numerics("fixed_cuda") == ("int32", 4)
    with pytest.raises(KeyError, match="no MFU numerics"):
        backend_numerics("fixed_pallas")


# ---------------------------------------------------------------------------
# MFU arithmetic
# ---------------------------------------------------------------------------

def test_mfu_in_unit_interval_for_every_backend_and_route():
    device = DEVICE_DB["cpu"]
    for backend in BACKEND_NUMERICS:
        dtype, wb = backend_numerics(backend)
        for route in mfu.ROUTE_WORKLOADS:
            wl = route_workload(route, 112, 112, 144, wb)
            t, basis = mfu_clock(wl, 123.0, device=device, dtype=dtype, plain=True)
            assert basis == "roofline_model"
            assert t == modeled_seconds(wl, device=device, dtype=dtype)
            val = mfu.mfu(wl, t, device=device, dtype=dtype)
            assert 0.0 < val <= 1.0, (backend, route, val)


def test_mfu_clock_measured_on_the_card():
    wl = route_workload("sweep_megakernel", 112, 112, 144, 4)
    t, basis = mfu_clock(wl, 0.5, device=DEVICE_DB["h100"], dtype="int32", plain=False)
    assert (t, basis) == (0.5, "measured")


def test_roofline_terms_on_the_card():
    wl = trunk_workload(1080, 1920, "sweep_megakernel")
    t = mfu.roofline_terms(wl, device=DEVICE_DB["h100"], dtype="int32")
    # the words its blocks read outweigh its operations over the int32 lanes
    assert t["bound"] == "memory" and t["device"] == "h100"
    assert t["memory_s"] == wl.bytes_total / 3.35e12
    assert t["compute_s"] == wl.flops / (132 * 64 * 1.98e9)
    assert t == {**jmfu.roofline_terms(wl, device=jmfu.DeviceSpec(
        "h100", ("H100",), dict(DEVICE_DB["h100"].peak_flops), 3.35e12, ""),
        dtype="int32")}


def test_achieved_rejects_nonpositive_time():
    with pytest.raises(ValueError, match="positive duration"):
        mfu.achieved(Workload("w", 100, 4, 4, 4), 0.0)


# ---------------------------------------------------------------------------
# launches: kernel names from profiler events
# ---------------------------------------------------------------------------

def test_kernel_names_from_demangled_and_mangled_events():
    events = [
        "void frame_trunk_kernel<(FixedRound)1, 16, 32>(int const*, int const*, int*, int)",
        "_Z24fixed_window_head_kernelILi16ELi16EEvPKiS1_Pi",
        "fixed_smallnet_kernel",
        "void (anonymous namespace)::qmm_wgmma_kernel<128>(CUtensorMap_st, float*)",
        "void qmm_transpose_kernel(signed char const*, signed char*, int, int)",
        "void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
        "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)",
        "Memcpy HtoD (Pageable -> Device)",
        "void conv2d_tile_kernel<4, 1, 2, 2>(float const*, float*)",
        "void conv2d_direct_kernel<1>(float const*, float*)",
        "void frame_trunk_kernel<(FixedRound)0, 8, 8>(int const*, int const*, int*, int)",
    ]
    assert [L.kernel_base_name(e) for e in events[:4]] == [
        "frame_trunk_kernel", "fixed_window_head_kernel", "fixed_smallnet_kernel",
        "qmm_wgmma_kernel"]
    assert L.kernel_base_name(events[4]) in L.HELPER_KERNELS
    assert L.kernel_counts(events) == {"frame_trunk": 2, "fixed_window_head": 1,
                                       "fixed_smallnet": 1, "quant_matmul": 1, "conv2d": 2}
    assert L.kernel_counts([]) == {}


class _FakeEvent:
    def __init__(self, name):
        self.name, self.device_type = name, torch.autograd.DeviceType.CUDA


@pytest.mark.parametrize("events, want", [
    (["void frame_trunk_kernel<(FixedRound)1, 16, 32>(int const*, int*, int)",
      "Memcpy HtoD (Pageable -> Device)"], {"frame_trunk": 1}),
    (["Memcpy HtoD (Pageable -> Device)"], RuntimeError),
    ([], L.LostWindow),
])
def test_count_launches_against_the_profilers_events(monkeypatch, events, want):
    """count_launches over a call that launches one frame_trunk, with the
    profiler's device events faked: the same count is returned, another
    raises, and a window with no device activity raises LostWindow."""
    import collections
    import contextlib

    import torch.profiler as tp
    from repro_torch.kernels import _launch

    @contextlib.contextmanager
    def fake_profile(activities):
        yield type("Prof", (), {"events": lambda self: [_FakeEvent(n) for n in events]})()
    monkeypatch.setattr(tp, "profile", fake_profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(L, "WINDOW_PAD_S", 0.0)
    monkeypatch.setattr(_launch, "LAUNCHES", collections.Counter())
    call = lambda: _launch.count_launch("frame_trunk")
    if isinstance(want, dict):
        assert L.count_launches(call) == want
    else:
        with pytest.raises(want) as e:
            L.count_launches(call)
        assert (e.type is L.LostWindow) == (want is L.LostWindow)
        if e.type is L.LaunchMismatch:         # the two counts, for a caller to read
            assert (e.value.seen, e.value.counted) == ({}, {"frame_trunk": 1})


def test_profiler_windows_needs_the_card():
    """The window probe reads the card's activity: the CPU is refused, and
    the default device raises where there is no card."""
    from repro_torch.analysis import profiler_windows as PW
    with pytest.raises(ValueError, match="has none"):
        PW.main(["--device", "cpu", "--seconds", "0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            PW.main(["--seconds", "0"])


def test_the_table_covers_every_kernel_and_wrapper():
    sources = "".join(p.read_text() for p in CSRC.glob("*.cu"))
    kernels = set(re.findall(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)\s+)?"
                             r"(?:void\s+)?(\w+_kernel)\s*\(", sources))
    ops = "".join(p.read_text() for p in (CSRC.parent / "kernels").rglob("ops.py"))
    triton = set(re.findall(r"@triton\.jit(?:\([^)]*\))?\s+def\s+(\w+_kernel)\s*\(", ops))
    assert kernels and triton
    assert kernels | triton == set(L.KERNEL_LAUNCHES) | set(L.HELPER_KERNELS)
    wrappers = set(re.findall(r'count_launch\("(\w+)"\)', ops))
    assert wrappers == set(L.KERNEL_LAUNCHES.values())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler counts kernels the card ran")
    return torch.device("cuda")


def test_count_launches_agrees_with_the_wrappers_on_card(cuda):
    import numpy as np
    from repro_torch.streaming import FcnSweep
    rng = np.random.default_rng(0)
    params = {"conv1": {"w": rng.uniform(-1, 1, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
              "conv2": {"w": rng.uniform(-1, 1, (2, 2, 1, 1)), "b": rng.normal(0, .5, (1,))},
              "dense": {"w": rng.uniform(-.6, .6, (49, 10)), "b": rng.normal(0, .5, (10,))}}
    frame = rng.random((1, 112, 112, 1), dtype=np.float32)
    assert L.count_launches(FcnSweep(stride=8).score, params, frame, backend="fixed_cuda") == \
        {"frame_trunk": 1, "fixed_window_head": 1}
