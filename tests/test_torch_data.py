"""The port's data pipeline (``repro_torch.data``) against the JAX
package's ``repro.data``: both are numpy only, so every batch is held
``array_equal`` (synthetic streams for several seeds, steps and hosts, a
memmapped corpus, prefetch order and a resumed prefetcher)."""
import torch_threads  # noqa: F401  (one torch thread a test worker)
import types

import numpy as np
import pytest

from repro_torch import data as tdata
from test_torch_model import reference_shim


@pytest.fixture(scope="module")
def ref():
    with reference_shim():
        from repro import data

        yield types.SimpleNamespace(data=data)


def _equal(a: dict, b: dict) -> None:
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("seed,host,hosts", [(0, 0, 1), (5, 0, 1), (1, 1, 2), (7, 3, 4)])
def test_synthetic_batches_equal(ref, seed, host, hosts):
    kw = dict(seed=seed, host_id=host, num_hosts=hosts)
    a = tdata.SyntheticLM(1024, 64, 8, **kw)
    b = ref.data.SyntheticLM(1024, 64, 8, **kw)
    for step in (0, 1, 17, 123):
        _equal(a.batch_at(step), b.batch_at(step))


def test_memmap_batches_equal(ref, tmp_path):
    path = str(tmp_path / "toks.bin")
    np.random.RandomState(0).randint(0, 5000, 100_000).astype(np.int32).tofile(path)
    for host in (0, 1):
        a = tdata.MemmapLM(path, seq_len=32, global_batch=4, host_id=host, num_hosts=2)
        b = ref.data.MemmapLM(path, seq_len=32, global_batch=4, host_id=host, num_hosts=2)
        for step in (0, 1, 2, 500):
            _equal(a.batch_at(step), b.batch_at(step))


@pytest.mark.parametrize("start", [0, 10])
def test_prefetch_order_and_resume(ref, start):
    """A prefetcher started at ``start`` (a resumed run) yields the steps
    from there in order, each the reference's batch."""
    src = tdata.SyntheticLM(256, 16, 4, seed=3)
    rsrc = ref.data.SyntheticLM(256, 16, 4, seed=3)
    pf = tdata.Prefetcher(src, start_step=start)
    try:
        for expect in range(start, start + 4):
            step, batch = next(pf)
            assert step == expect
            _equal(batch, rsrc.batch_at(expect))
    finally:
        pf.close()
