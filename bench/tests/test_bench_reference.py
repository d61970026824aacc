"""The NumPy reference against the frozen golden vectors, word for word,
and its float path against the program's plain PLAN path on the CPU."""
import json
import pathlib

import numpy as np
import pytest

from bench.reference import smallnet as ref
from bench.reference import sweep as rs
from bench.traffic import render

GOLDEN = pathlib.Path(__file__).resolve().parents[2] / "tests" / "golden"
WRAPAROUND = ("q16_16", "q16_16_trunc", "q8_8")


def _golden(name):
    return json.loads((GOLDEN / name).read_text())


def _seeded_params():
    leaves = _golden("seeded_params.json")["params"]
    return {layer: {k: np.asarray(v["values"], np.float32).reshape(v["shape"])
                    for k, v in lv.items()} for layer, lv in leaves.items()}


@pytest.mark.parametrize("fmt_name", WRAPAROUND)
def test_word_ops_equal_the_golden_vectors(fmt_name):
    g = _golden("fixed_golden.json")
    fmt = ref.format_of(g["configs"][fmt_name])
    case = g["cases"][fmt_name]
    cv = case["conv"]
    x, w4 = np.asarray(cv["x"]), np.asarray(cv["w4"])
    conv = ref.conv_words(x, w4, cv["b"], fmt)
    np.testing.assert_array_equal(conv, cv["out"])
    np.testing.assert_array_equal(ref.pool(ref.plan_words(conv, fmt)), cv["out_fused_plan_pool"])
    np.testing.assert_array_equal(ref.pool(np.asarray(case["pool"]["x"])), case["pool"]["out"])
    np.testing.assert_array_equal(ref.plan_words(np.asarray(case["sigmoid"]["x"]), fmt),
                                  case["sigmoid"]["out"])
    d = case["dense"]
    np.testing.assert_array_equal(
        ref.dense_words(np.asarray(d["x"]), np.asarray(d["w"]), np.asarray(d["b"]), fmt), d["out"])


def test_saturating_formats_are_refused():
    with pytest.raises(ValueError):
        ref.format_of({"total_bits": 32, "frac_bits": 16, "saturate": True})


def test_sweep_window_scores_equal_the_golden_words():
    """The copied video generator's frame (seed 7) and the reference's
    whole net on every 28x28 crop give the sweep golden's 144 x 10 words."""
    g = _golden("sweep_golden.json")
    frame = render.video_frames(1, (112, 112), seed=7)[0]
    pos = rs.positions((112, 112), 28, g["stride"])
    assert [list(p) for p in pos] == g["positions"]
    scores = rs.window_scores(frame, pos, lambda c: ref.net_words(_seeded_params(), c, ref.Q16_16))
    np.testing.assert_array_equal(scores, g["scores"])


def test_float_net_matches_the_programs_plain_plan_path():
    import torch
    from repro_torch.core import smallnet
    from bench.harness import params_from_seed
    params = params_from_seed(5)
    images = np.stack([render.digit_image(5, i, i % 10) for i in range(64)])
    want = ref.net_float(params, images)
    tp = {k: {n: torch.from_numpy(v) for n, v in lv.items()} for k, lv in params.items()}
    got = smallnet.apply(tp, torch.from_numpy(images), backend="plan", device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-6


def test_bf16_rounding_and_the_controls_gap():
    """`to_bf16` rounds as torch's bfloat16 cast does (ties to even), and the
    bfloat16 control's scores lie far outside float32 rounding."""
    import torch
    from bench.harness import params_from_seed
    x = np.random.default_rng(3).normal(size=4096).astype(np.float32)
    x[:3] = [1.0, 1.00390625, 1.005859375]
    np.testing.assert_array_equal(ref.to_bf16(x),
                                  torch.from_numpy(x).to(torch.bfloat16).float().numpy())
    params = params_from_seed(9)
    images = np.stack([render.digit_image(9, i, i % 10) for i in range(32)])
    gap = np.abs(ref.net_float(params, images, ref.to_bf16) - ref.net_float(params, images))
    assert gap.max() > 1e-3


def test_detections_greedy_and_threshold():
    conf = np.zeros((4, 10), np.float32)
    conf[0, 3], conf[1, 4], conf[2, 5], conf[3, 6] = 0.9, 0.95, 0.8, 0.95
    pos = [(0, 0), (0, 8), (40, 40), (0, 16)]
    # (0, 8) wins, then (0, 16) is 8 px away: suppressed; (0, 0) too; (40, 40) stays
    assert rs.detections(conf, pos, 0.8, 14) == [(4, float(np.float32(0.95)), 0, 8),
                                                  (5, float(np.float32(0.8)), 40, 40)]
    assert rs.percentile_threshold(conf, 50) in {float(v) for v in conf.max(axis=1)}
