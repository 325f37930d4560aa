"""Port of the synthetic token pipeline (``data/pipeline.py``) held against
the JAX package's ``repro.data``: both draw every row from the same
``np.random.default_rng`` seeds, so batches are byte-identical (no
tolerance) for every (config, step, host); plus the five properties of
``tests/test_data_pipeline.py``, run against the port."""
import numpy as np
import pytest

from repro_torch.data import (DataConfig, SyntheticLM, global_batch_for_step,
                              host_batch_for_step)

#: (vocab, seq_len, global_batch, seed, n_hosts): the train tests' CFG,
#: the lifecycle's, a 4-host split, another seed, and minicpm-2b's vocab
CONFIGS = [(64, 24, 8, 0, 1), (96, 40, 8, 0, 1), (64, 16, 8, 0, 4),
           (128, 32, 6, 7, 2), (122753, 64, 2, 0, 1)]


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("conf", CONFIGS, ids=lambda c: "-".join(map(str, c)))
def test_batches_byte_identical_to_reference(conf):
    """``global_batch_for_step`` and each host's ``host_batch_for_step``
    against ``repro.data``'s, at steps 0, 1, 900 and 1800 (the tests'
    training, calibration and evaluation steps)."""
    from repro.data import DataConfig as JDataConfig
    from repro.data import global_batch_for_step as jglobal
    from repro.data import host_batch_for_step as jhost
    vocab, seq, gb, seed, hosts = conf
    kw = dict(vocab=vocab, seq_len=seq, global_batch=gb, seed=seed,
              n_hosts=hosts)
    cfg, jcfg = DataConfig(**kw), JDataConfig(**kw)
    for step in (0, 1, 900, 1800):
        _same(global_batch_for_step(cfg, step), jglobal(jcfg, step))
        for h in range(hosts):
            _same(host_batch_for_step(cfg, step, h), jhost(jcfg, step, h))


def test_rows_byte_identical_to_reference():
    """``SyntheticLM.batch`` over an arbitrary row range (skip-ahead)."""
    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticLM as JSyntheticLM
    kw = dict(vocab=200, seq_len=33, global_batch=64, seed=3)
    _same(SyntheticLM(DataConfig(**kw)).batch(17, range(40, 47)),
          JSyntheticLM(JDataConfig(**kw)).batch(17, range(40, 47)))


def test_deterministic_and_addressable():
    cfg = DataConfig(vocab=128, seq_len=32, global_batch=8)
    b1 = global_batch_for_step(cfg, 5)
    b2 = global_batch_for_step(cfg, 5)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    b3 = global_batch_for_step(cfg, 6)
    assert not np.array_equal(b1["tokens"], b3["tokens"])


def test_host_shards_partition_global_batch():
    cfg = DataConfig(vocab=64, seq_len=16, global_batch=8, n_hosts=4)
    full = global_batch_for_step(cfg, 3)["tokens"]
    parts = [host_batch_for_step(cfg, 3, h)["tokens"] for h in range(4)]
    np.testing.assert_array_equal(np.concatenate(parts, axis=0), full)


def test_elastic_repartition():
    """Changing host count re-partitions the SAME global stream."""
    base = DataConfig(vocab=64, seq_len=16, global_batch=8, n_hosts=2)
    more = DataConfig(vocab=64, seq_len=16, global_batch=8, n_hosts=4)
    two = np.concatenate([host_batch_for_step(base, 9, h)["tokens"]
                          for h in range(2)])
    four = np.concatenate([host_batch_for_step(more, 9, h)["tokens"]
                           for h in range(4)])
    np.testing.assert_array_equal(two, four)


def test_targets_shift():
    cfg = DataConfig(vocab=64, seq_len=16, global_batch=2)
    b = global_batch_for_step(cfg, 0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["targets"][:, :-1])


def test_learnable_structure():
    """The Markov source has sub-vocab-entropy successor structure."""
    cfg = DataConfig(vocab=64, seq_len=512, global_batch=4)
    b = global_batch_for_step(cfg, 0)
    toks, tgts = b["tokens"], b["targets"]
    deltas = (tgts - toks) % cfg.vocab
    _, counts = np.unique(deltas, return_counts=True)
    p = counts / counts.sum()
    ent = -(p * np.log2(p)).sum()
    assert ent < 0.8 * np.log2(cfg.vocab)  # structure present
