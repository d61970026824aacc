"""The port's block-int8 compression against the JAX reference, on the CPU.

- `_quantize_block`: int8 words and float32 scales equal the reference's
  on numpy-seeded inputs (several scales, zeros, an outlier, a hypothesis
  sweep); the reference's error-bound property;
- `compression_error_feedback`: `to_send` and the residual equal the
  reference's word for word over two rounds, odd leaf sizes included;
- `make_compressed_allreduce` in a spawned 4-rank gloo group
  (`test_torch_sharding.spawn_ranks`): with identical inputs on every rank
  it equals the reference's on 4 virtual CPU devices; with different
  inputs it equals the numpy formula of the reference's
  `compressed_psum` (int32 sum of the words, the float32 scale sum over
  the peer count);
- the bytes the port's all_reduce calls move (`allreduce_bytes`), which
  are no fewer than a float32 all-reduce's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
hp = pytest.importorskip("hypothesis", reason="property tests need hypothesis")
st = pytest.importorskip("hypothesis.strategies")

import jax.numpy as jnp  # noqa: E402

from repro.distributed import compression as JC  # noqa: E402
from repro_torch.distributed import compression as C  # noqa: E402
from test_torch_sharding import init_rank, reference_subprocess, spawn_ranks  # noqa: E402

SHAPES = [(4, C.BLOCK), (1, C.BLOCK), (33, C.BLOCK)]


def _quantize_both(x: np.ndarray):
    q, s = C._quantize_block(torch.from_numpy(x))
    jq, js = JC._quantize_block(jnp.asarray(x))
    return q, s, np.asarray(jq), np.asarray(js)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.5, 1e4])
def test_quantize_block_equals_reference(shape, scale):
    rng = np.random.default_rng(int(scale * 1000) + shape[0])
    x = rng.normal(0, scale, shape).astype(np.float32)
    x[0, :7] = 0.0
    x[-1, 3] = 50 * scale                            # an outlier in the last block
    q, s, jq, js = _quantize_both(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)


def test_quantize_block_of_zeros_equals_reference():
    q, s, jq, js = _quantize_both(np.zeros((2, C.BLOCK), np.float32))
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)


@hp.given(st.integers(0, 2**31 - 1), st.floats(0.01, 100.0))
@hp.settings(max_examples=50, deadline=None)
def test_quantize_block_equals_reference_hypothesis(seed, scale):
    x = np.random.default_rng(seed).normal(0, scale, (4, C.BLOCK)).astype(np.float32)
    q, s, jq, js = _quantize_both(x)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)


@hp.given(st.integers(0, 2**31 - 1), st.floats(0.01, 100.0))
@hp.settings(max_examples=50, deadline=None)
def test_block_quant_error_bound(seed, scale):
    x = torch.from_numpy(np.random.default_rng(seed).normal(0, scale, (4, C.BLOCK))
                         .astype(np.float32))
    q, s = C._quantize_block(x)
    deq = q.to(torch.float32) * s
    bound = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0 / 2 + 1e-5
    assert bool(torch.all(torch.abs(deq - x) <= bound + 1e-6))


def _grads(rng):
    return {"w": rng.normal(0, 1, (512,)).astype(np.float32),
            "b": rng.normal(0, 3, (7, 45)).astype(np.float32),         # not whole blocks
            "s": np.float32(rng.normal()).reshape(())}


def test_error_feedback_equals_reference(rng):
    g1, g2 = _grads(rng), _grads(rng)
    t = lambda g: {k: torch.from_numpy(np.array(v)) for k, v in g.items()}      # noqa: E731
    j = lambda g: {k: jnp.asarray(v) for k, v in g.items()}                     # noqa: E731
    sent1, res1 = C.compression_error_feedback(t(g1), None)
    jsent1, jres1 = JC.compression_error_feedback(j(g1), None)
    sent2, res2 = C.compression_error_feedback(t(g2), res1)
    jsent2, jres2 = JC.compression_error_feedback(j(g2), jres1)
    for got, want in ((sent1, jsent1), (res1, jres1), (sent2, jsent2), (res2, jres2)):
        for k in g1:
            assert got[k].dtype == torch.float32 and got[k].shape == tuple(want[k].shape)
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_error_feedback_bounds_the_residual(rng):
    g = {"w": torch.from_numpy(rng.normal(0, 1, (512,)).astype(np.float32))}
    sent1, res = C.compression_error_feedback(g, None)
    assert torch.equal(sent1["w"], g["w"])               # no residual yet
    _, res2 = C.compression_error_feedback(g, res)
    for r in (res, res2):
        assert float(r["w"].abs().max()) <= float(g["w"].abs().max() * 2) / 127.0 + 1e-6


def test_error_feedback_keeps_the_leaf_dtype():
    g = {"w": torch.linspace(-1, 1, 300, dtype=torch.bfloat16)}
    sent, res = C.compression_error_feedback(g, None)
    assert sent["w"].dtype == res["w"].dtype == torch.bfloat16


def test_allreduce_bytes_are_not_fewer_than_float32():
    """The words go over the wire as int32, as the reference's psum carries
    them: no 4x saving, a scale a block and the peer count on top."""
    for n in (1, 255, 256, 4096, 2_534_000_000):
        blocks = -(-n // C.BLOCK)
        assert C.allreduce_bytes(n) == 4 * blocks * C.BLOCK + 4 * blocks + 4 >= 4 * n


# -- the compressed all-reduce over 4 ranks -----------------------------------------

N = 1000                                            # not whole blocks


def _rank_input(rank: int, same: bool) -> np.ndarray:
    return np.random.default_rng(0 if same else 100 + rank).normal(0, 1, (N,)).astype(np.float32)


def _allreduce_worker(rank, world, store, out_dir, same):
    init_rank(rank, world, store)
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    try:
        mesh = make_device_mesh((world,), ("pod",))
        g = torch.from_numpy(_rank_input(rank, same))
        out = C.make_compressed_allreduce(mesh, "pod")({"g": g, "h": g[:10].clone()})
        np.save(f"{out_dir}/rank{rank}.npy", out["g"].numpy())
        np.save(f"{out_dir}/rank{rank}_h.npy", out["h"].numpy())
    finally:
        dist.destroy_process_group()


_PSUM = """
    import json
    import jax, jax.numpy as jnp, numpy as np
    from repro.distributed.compression import make_compressed_allreduce
    mesh = jax.make_mesh((4,), ("pod",), axis_types=(jax.sharding.AxisType.Auto,))
    g = jnp.asarray(np.random.default_rng(0).normal(0, 1, (%d,)).astype(np.float32))
    out = make_compressed_allreduce(mesh, axis="pod")({"g": g, "h": g[:10]})
    print(json.dumps({k: np.asarray(v).tolist() for k, v in out.items()}))
"""


def test_compressed_allreduce_4_ranks_equals_reference(tmp_path):
    want = reference_subprocess(_PSUM % N, 4)
    spawn_ranks(_allreduce_worker, 4, tmp_path, str(tmp_path), True)
    for rank in range(4):
        for k, suffix in (("g", ""), ("h", "_h")):
            got = np.load(tmp_path / f"rank{rank}{suffix}.npy")
            np.testing.assert_array_equal(got, np.asarray(want[k], np.float32))
    g = _rank_input(0, True)
    assert np.abs(np.load(tmp_path / "rank0.npy") - g).max() <= 4.0 / 127.0


def _formula(inputs: list[np.ndarray]) -> np.ndarray:
    """The reference's compressed_psum in numpy, then the mean."""
    qs, ss = [], []
    for x in inputs:
        q, s = JC._quantize_block(jnp.asarray(np.pad(x, (0, (-x.size) % C.BLOCK))
                                              .reshape(-1, C.BLOCK)))
        qs.append(np.asarray(q).astype(np.int32))
        ss.append(np.asarray(s))
    qsum = np.sum(qs, axis=0, dtype=np.int32)
    ssum = np.float32(0)
    for s in ss:                                    # float32, in rank order
        ssum = (ssum + s).astype(np.float32)
    out = qsum.astype(np.float32) * (ssum / np.float32(len(inputs)))
    return (out.reshape(-1)[:inputs[0].size] / np.float32(len(inputs))).astype(np.float32)


def test_compressed_allreduce_4_ranks_different_inputs_equals_the_formula(tmp_path):
    spawn_ranks(_allreduce_worker, 4, tmp_path, str(tmp_path), False)
    want = _formula([_rank_input(r, False) for r in range(4)])
    for rank in range(4):
        np.testing.assert_array_equal(np.load(tmp_path / f"rank{rank}.npy"), want)
