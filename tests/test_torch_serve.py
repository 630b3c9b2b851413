"""The port's GenerationService: counterparts of the micro-batching, warmup
and real-decode tests of tests/test_serve.py, on ``device="cpu"``."""
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pianobart_tpu_torch.compat.from_jax import init_lm
from pianobart_tpu_torch.decode import generate
from pianobart_tpu_torch.models import PianoBartConfig
from pianobart_tpu_torch.serve.app import GenerationService, _batch_seed

torch.set_num_threads(2)


def test_generation_service_micro_batching():
    """Concurrent submits are coalesced into batched decodes."""
    svc = GenerationService(device="cpu", max_batch=8, batch_window_s=0.05)
    calls = []

    def fake_decode(intros, seeds):
        calls.append(len(seeds))
        time.sleep(0.01)
        return intros + 1  # identifiable per-request output

    svc._decode_batch = fake_decode
    n = 6
    results = [None] * n

    def worker(i):
        results[i] = svc.submit(np.full((16, 8), i, dtype=np.int32), seed=i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for i in range(n):
        np.testing.assert_array_equal(results[i], np.full((16, 8), i + 1))
    assert sum(svc.batch_sizes_served) == n
    assert max(svc.batch_sizes_served) > 1


def test_generation_service_warmup_buckets():
    """warmup() decodes at every reachable power-of-two bucket, and only
    those."""
    for max_batch, expect in [(8, [1, 2, 4, 8]), (6, [1, 2, 4, 8]),
                              (1, [1]), (16, [1, 2, 4, 8, 16])]:
        svc = GenerationService(device="cpu", max_batch=max_batch)
        svc._ready = True  # skip model load
        svc.cfg = SimpleNamespace(max_len=16)
        calls = []
        svc._decode_batch = lambda intros, seeds: (
            calls.append(intros.shape), intros)[1]
        timings = svc.warmup()
        assert [s[0] for s in calls] == expect, (max_batch, calls)
        assert all(s[1:] == (16, 8) for s in calls)
        assert sorted(timings) == expect
        assert {svc._bucket_of(n) for n in range(1, max_batch + 1)} == set(expect)


def test_generation_service_warmup_real_decode():
    """warmup() through the real decode path (small config, CPU), then a
    submit served alone equals a direct generate with its seed."""
    cfg = PianoBartConfig(d_model=32, emb_size=16, encoder_layers=1,
                          decoder_layers=1, ffn_dim=64, num_heads=2,
                          max_len=16)
    svc = GenerationService(cfg=cfg, device="cpu", seed=3, max_batch=2,
                            batch_window_s=0.01)
    timings = svc.warmup()
    assert sorted(timings) == [1, 2]
    intro = np.random.default_rng(0).integers(0, 30, (16, 8))
    out = svc.submit(intro, seed=7)
    assert out.shape == (16, 8)
    gen = torch.Generator().manual_seed(_batch_seed([7]))
    want = generate(init_lm(cfg, 3, "cpu"), intro[None], generator=gen,
                    device="cpu")[0].numpy()
    np.testing.assert_array_equal(out, want)


def test_batch_seed_folds_every_request_seed():
    assert _batch_seed([7]) == 7
    assert _batch_seed([1, 2]) != _batch_seed([2, 1])
    assert _batch_seed([1, 2, 3]) != _batch_seed([1, 2])


def test_generation_service_error_propagates():
    svc = GenerationService(device="cpu", batch_window_s=0.0)

    def boom(intros, seeds):
        raise RuntimeError("decode failed")

    svc._decode_batch = boom
    with pytest.raises(RuntimeError, match="decode failed"):
        svc.submit(np.zeros((4, 8), np.int32))
    # the worker survives a failing batch and serves the next one
    svc._decode_batch = lambda intros, seeds: intros
    np.testing.assert_array_equal(svc.submit(np.ones((4, 8), np.int32)),
                                  np.ones((4, 8), np.int32))


def test_generation_service_delivers_a_base_exception():
    """A SystemExit raised in a decode reaches its submitter, as the
    reference's worker delivers any BaseException, and the worker thread
    lives on to serve the next request."""
    svc = GenerationService(device="cpu", batch_window_s=0.0)

    def leave(intros, seeds):
        raise SystemExit(3)

    svc._decode_batch = leave
    with pytest.raises(SystemExit):
        svc.submit(np.zeros((4, 8), np.int32))
    worker = svc._worker
    svc._decode_batch = lambda intros, seeds: intros + 2
    np.testing.assert_array_equal(svc.submit(np.ones((4, 8), np.int32)),
                                  np.full((4, 8), 3, np.int32))
    assert svc._worker is worker and worker.is_alive()


def test_entry_points_without_a_device_raise_when_cuda_is_absent(monkeypatch):
    """No silent fallback to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationService()
    cfg = PianoBartConfig(d_model=32, emb_size=16, encoder_layers=1,
                          decoder_layers=1, ffn_dim=64, num_heads=2, max_len=16)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_lm(cfg)
    model = init_lm(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate(model, np.zeros((16, 8), np.int64))
