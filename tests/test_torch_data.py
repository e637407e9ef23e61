"""The port's data modules against the JAX package's.

`repro_torch/data/synthetic.py` is a copy of `repro/data/synthetic.py`
(numpy only; the port imports nothing of `repro`), held equal here batch
for batch across steps, starts and front-ends.  `DataPipeline` hands the
same batches to torch on the given device, and resumes exactly at
`start_step`.
"""
import numpy as np
import pytest
import torch

from repro.data import DataPipeline as JDataPipeline
from repro.data import SyntheticConfig as JSyntheticConfig
from repro.data import SyntheticTokenDataset as JSyntheticTokenDataset
from repro_torch.data import (
    DataPipeline,
    SyntheticConfig,
    SyntheticTokenDataset,
)

CONFIGS = [dict(vocab_size=256, seq_len=32),
           dict(vocab_size=151936, seq_len=1024, seed=7),
           dict(vocab_size=1000, seq_len=16, seed=3, d_model=24,
                frontend="audio")]


@pytest.mark.parametrize("kw", CONFIGS)
def test_synthetic_copy_equals_reference(kw):
    ref = JSyntheticTokenDataset(JSyntheticConfig(**kw))
    port = SyntheticTokenDataset(SyntheticConfig(**kw))
    for step, start, count in ((0, 0, 4), (1, 0, 4), (5, 2, 3),
                               (123456, 17, 2)):
        want = ref.batch(step, start, count)
        got = port.batch(step, start, count)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_gives_the_references_host_batches_as_tensors():
    kw = dict(vocab_size=256, seq_len=32, seed=1)
    ref = JDataPipeline(JSyntheticTokenDataset(JSyntheticConfig(**kw)), 8,
                        host_index=1, host_count=2)
    port = DataPipeline(SyntheticTokenDataset(SyntheticConfig(**kw)), 8,
                        host_index=1, host_count=2, device="cpu")
    for step in (0, 3):
        want = ref.host_batch(step)
        got = port.device_batch(step)
        assert got.keys() == want.keys()
        for k in want:
            assert isinstance(got[k], torch.Tensor)
            assert got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k])


def test_pipeline_resumes_exactly_at_start_step():
    ds = SyntheticTokenDataset(SyntheticConfig(vocab_size=500, seq_len=16))
    pipe = DataPipeline(ds, 4, device="cpu", prefetch_depth=2)
    it = pipe(0)
    first = [next(it) for _ in range(6)]
    it.close()
    it = pipe(start_step=3)
    resumed = [next(it) for _ in range(3)]
    it.close()
    for a, b in zip(first[3:], resumed):
        for k in a:
            assert torch.equal(a[k], b[k])
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])


def test_pipeline_raises_the_workers_error():
    class Broken(SyntheticTokenDataset):
        def batch(self, step, start_index, count):
            if step == 2:
                raise RuntimeError("no batch 2")
            return super().batch(step, start_index, count)
    pipe = DataPipeline(Broken(SyntheticConfig(vocab_size=50, seq_len=8)),
                        2, device="cpu")
    it = pipe(0)
    next(it), next(it)
    with pytest.raises(RuntimeError, match="no batch 2"):
        next(it)


def test_pipeline_refuses_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="does not split"):
        DataPipeline(SyntheticTokenDataset(SyntheticConfig(10, 4)), 5,
                     host_count=2, device="cpu")
