"""The port's profiling helpers (``utils/profiling.py``): ``StepTimer`` and
``block`` as ``tests/test_logging_utils.py`` pins the JAX package's, and
``trace`` writing a Chrome trace on the CPU; its memory snapshot needs a
card (``tests/test_torch_cuda.py`` writes one there)."""
import json
import os
import time

import numpy as np
import pytest
import torch

from pianobart_tpu.utils.profiling import StepTimer as JaxStepTimer
from pianobart_tpu_torch.utils import profiling
from pianobart_tpu_torch.utils.profiling import StepTimer, block, trace


def test_step_timer_returns_wall_time():
    with StepTimer() as t:
        t.observe(torch.arange(8))
    assert t.last_ms is not None and t.last_ms >= 0.0
    block({"a": torch.arange(3), "b": None, "c": [np.arange(2), (torch.ones(1),)]})


def test_step_timer_counts_like_jax():
    """``count``, ``total_s`` and ``mean_ms`` accumulate over steps, as the
    JAX timer's do; ``observe`` returns its argument and is cleared on
    exit."""
    ours, theirs = StepTimer(), JaxStepTimer()
    assert ours.mean_ms == theirs.mean_ms == 0.0
    for _ in range(3):
        for timer in (ours, theirs):
            with timer:
                out = timer.observe(torch.ones(2))
                time.sleep(0.002)
            assert out is not None and timer._result is None
    for timer in (ours, theirs):
        assert timer.count == 3 and timer.total_s >= 0.006
        assert timer.mean_ms == pytest.approx(timer.total_s / 3 * 1e3)
        assert timer.last_ms >= 2.0


def test_block_synchronizes_each_cuda_device_once(monkeypatch):
    """Every CUDA device of the tree is waited for once; host tensors need
    no wait."""
    waited = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: waited.append(d))

    class Fake:
        is_cuda, device = True, torch.device("cuda", 1)
    monkeypatch.setattr(profiling, "_tensors", lambda tree: iter([Fake(), Fake()]))
    block({"x": 1})
    assert waited == [torch.device("cuda", 1)]
    monkeypatch.undo()
    waited.clear()
    block([torch.ones(2), {"y": torch.zeros(1)}])
    assert waited == []


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    log_dir = str(tmp_path / "trace")
    with trace(log_dir, with_memory=False) as prof:
        x = torch.randn(64, 64)
        (x @ x).sum()
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name")) for e in events)
    assert prof.key_averages()
    assert not os.path.exists(os.path.join(log_dir, profiling.MEMORY_FILE))


def test_trace_with_memory_needs_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with trace(str(tmp_path / "t")):
            pass
    assert not os.path.exists(str(tmp_path / "t"))
