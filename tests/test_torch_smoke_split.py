"""``daft_tpu_torch.tools.smoke_split``: the wrapper that times a helper, and
the exit without a CUDA device (the phase itself runs only on the GPU)."""

import collections
import types

import pytest
import torch

from daft_tpu_torch.tools import smoke_split


def test_timed_wrapper_counts_calls_and_keeps_results_and_errors():
    owner = types.SimpleNamespace(f=lambda x: x * 2)

    def boom():
        raise ValueError("boom")

    owner.g = boom
    totals, calls = collections.defaultdict(float), collections.Counter()
    smoke_split.timed(owner, "f", "f", totals, calls)
    smoke_split.timed(owner, "g", "g", totals, calls)
    assert [owner.f(i) for i in range(3)] == [0, 2, 4]
    with pytest.raises(ValueError, match="boom"):
        owner.g()
    assert calls == {"f": 3, "g": 1}
    assert totals["f"] >= 0.0 and totals["g"] >= 0.0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the exit without a CUDA device")
def test_exits_2_without_a_cuda_device(capsys):
    assert smoke_split.main(["phase_relational", "check_q01"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
