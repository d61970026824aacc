"""The copied generators: pinned on fixed seeds, and equal to the program's
originals while those exist."""
import hashlib

import numpy as np
import pytest

from bench.traffic import render, schedule


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def test_digit_images_equal_loadgen_images():
    from repro_torch.streaming.loadgen import LoadGen
    gen = LoadGen(rate_qps=100.0, n_requests=8, seed=1234567891)
    for a in gen.schedule():
        np.testing.assert_array_equal(render.digit_image(1234567891, a.uid, a.label), gen.image(a))


def test_video_frames_equal_the_synthetic_source():
    from repro_torch.streaming.sources import SyntheticVideoSource
    want = [f.pixels for f in SyntheticVideoSource(n_frames=5, frame_shape=(72, 96), seed=31).frames()]
    got = render.video_frames(5, (72, 96), seed=31)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_generators_are_pinned_on_fixed_seeds():
    """Digests of one frame and one image, so that a change of the copies
    shows even after the program's originals are gone."""
    img = render.digit_image(7, 3, 4)
    assert img.shape == (28, 28, 1) and img.dtype == np.float32
    assert _digest(img) == "0e735715d4cb6cad"
    assert _digest(render.video_frames(1, (112, 112), seed=7)[0]) == "a521cf08c5ea5bc2"


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5])
def test_poisson_offers_the_same_count_on_every_seed(seed):
    t = schedule.arrivals("poisson", 2000.0, 3.0, n_streams=4, seed=seed)
    assert len(t) == 6000
    assert np.all(np.diff(t) >= 0) and t[0] >= 0.0 and t[-1] < 3.0
    np.testing.assert_array_equal(t, schedule.arrivals("poisson", 2000.0, 3.0, n_streams=4,
                                                       seed=seed))


def test_poisson_gaps_are_exponential():
    t = schedule.arrivals("poisson", 5000.0, 10.0, n_streams=4, seed=3)
    gaps = np.diff(t)
    cv = gaps.std() / gaps.mean()
    assert abs(cv - 1.0) < 0.03 and abs(gaps.mean() - 1 / 5000.0) < 1e-5


def test_bursty_equals_loadgen_bursty():
    from repro_torch.streaming.loadgen import LoadGen
    gen = LoadGen(process="bursty", rate_qps=400.0, duration_s=2.0, n_streams=3, seed=17,
                  burst_on_s=0.05, burst_off_s=0.15)
    want = np.asarray([a.t for a in gen.schedule()])
    got = schedule.arrivals("bursty", 400.0, 2.0, n_streams=3, seed=17, burst_on_s=0.05,
                            burst_off_s=0.15)
    np.testing.assert_array_equal(got, want)


def test_unknown_process_is_refused():
    with pytest.raises(ValueError):
        schedule.arrivals("diurnal", 10.0, 1.0, n_streams=1, seed=0)
