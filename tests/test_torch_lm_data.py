"""The port's deterministic LM data (`data/lm_data.py`) against the reference.

`host_batch` must give the reference's bytes for equal (seed, step,
host_index, n_hosts); plus the reference's four `lm_data` tests of
`tests/test_data.py`, on the port (its hypothesis sweep as parametrized
cases).
"""
import numpy as np
import pytest

from repro.data import lm_data as ref
from repro_torch.data import lm_data


@pytest.mark.parametrize("seed,step,host_index,n_hosts,vocab,seq_len,global_batch", [
    (0, 0, 0, 1, 512, 16, 8),
    (0, 17, 2, 4, 64, 8, 8),
    (7, 3, 0, 2, 49155, 256, 8),
    (123, 999, 3, 4, 97, 33, 12),
])
def test_host_batch_is_byte_identical_to_the_reference(seed, step, host_index, n_hosts,
                                                      vocab, seq_len, global_batch):
    kw = dict(vocab=vocab, seq_len=seq_len, global_batch=global_batch, seed=seed,
              n_hosts=n_hosts, host_index=host_index)
    got = lm_data.host_batch(lm_data.DataConfig(**kw), step)
    want = ref.host_batch(ref.DataConfig(**kw), step)
    assert sorted(got) == sorted(want) == ["labels", "tokens"]
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        assert got[k].shape == (global_batch // n_hosts, seq_len)
        assert got[k].tobytes() == want[k].tobytes()


def test_batches_iterates_host_batch_from_a_start_step():
    cfg = lm_data.DataConfig(vocab=128, seq_len=8, global_batch=2, seed=4)
    it = lm_data.batches(cfg, start_step=5)
    for step in (5, 6, 7):
        b = next(it)
        np.testing.assert_array_equal(b["tokens"], lm_data.host_batch(cfg, step)["tokens"])


def test_host_batch_refuses_an_uneven_host_split():
    with pytest.raises(ValueError, match="split"):
        lm_data.host_batch(lm_data.DataConfig(vocab=64, seq_len=8, global_batch=6,
                                              n_hosts=4), 0)


# -- the reference's lm_data tests (tests/test_data.py), on the port ----------

@pytest.mark.parametrize("seed,step", [(0, 0), (1, 50), (1000, 7), (37, 23)])
def test_host_batch_deterministic(seed, step):
    cfg = lm_data.DataConfig(vocab=128, seq_len=16, global_batch=4, seed=seed)
    a = lm_data.host_batch(cfg, step)
    b = lm_data.host_batch(cfg, step)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])


def test_labels_are_shifted_tokens():
    cfg = lm_data.DataConfig(vocab=64, seq_len=8, global_batch=2)
    b = lm_data.host_batch(cfg, 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_host_shard_replacement_property():
    """A replacement host regenerates exactly the failed host's shard."""
    mk = lambda host: lm_data.DataConfig(vocab=64, seq_len=8, global_batch=8, n_hosts=4,
                                         host_index=host)
    original = lm_data.host_batch(mk(2), step=17)
    replacement = lm_data.host_batch(mk(2), step=17)
    np.testing.assert_array_equal(original["tokens"], replacement["tokens"])
    other = lm_data.host_batch(mk(3), step=17)
    assert not np.array_equal(original["tokens"], other["tokens"])


def test_tokens_in_vocab_range():
    cfg = lm_data.DataConfig(vocab=97, seq_len=32, global_batch=4)
    b = lm_data.host_batch(cfg, 3)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 97
