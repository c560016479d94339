"""``ao_tpu_torch.utils.timing`` without a card: a device time is measured
on the device or not at all."""

import pytest
import torch

from ao_tpu_torch.utils import timing


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a CUDA device")
def test_cuda_time_ms_refuses_without_a_device():
    calls = []
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        timing.cuda_time_ms(lambda: calls.append(1))
    assert calls == []
