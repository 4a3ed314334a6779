"""The upload (`preworld_tpu_torch/data/synthetic.py::to_device`), held
byte for byte against `torch.from_numpy(np.ascontiguousarray(v))`.

On the CPU:
  * each dtype the batches carry, zero-size and scalar arrays, an array
    over 32 MB, many small arrays, non-contiguous views (strided,
    transposed, broadcast, reversed);
  * keys, shapes and dtypes in order; a synthetic training batch with the
    forecasting keys;
  * 16 threads uploading at once, each getting its own batch back.

On a card (marker `card`, skipped without one), with the stream held
busy so that the copies are still pending when the call returns:
  * the sources overwritten at once after the call, the results kept;
  * five batches in a row, so that pinned blocks freed behind pending
    copies come back to later calls, every result kept.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from preworld_tpu_torch.data import synthetic_batch, tiny_config, to_device

CPU = torch.device("cpu")
MB = 1 << 20


def plain(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def assert_same(got, batch, device=CPU):
    want = plain(batch)
    assert list(got) == list(want)
    for k, w in want.items():
        g = got[k]
        assert g.device == device
        g = g.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.is_contiguous()
        assert torch.equal(g.reshape(-1).view(torch.uint8)
                           if g.numel() else g,
                           w.reshape(-1).view(torch.uint8)
                           if w.numel() else w), k


def mixed(rng, n):
    """`n` bytes of each dtype the batches carry."""
    return {
        "f32": rng.normal(size=n // 4).astype(np.float32),
        "i32": rng.integers(-2**31, 2**31 - 1, n // 4, dtype=np.int32),
        "i64": rng.integers(-2**62, 2**62, n // 8, dtype=np.int64),
        "u8": rng.integers(0, 256, n, dtype=np.uint8),
        "bool": rng.uniform(size=n) > 0.5,
        "f64": rng.normal(size=n // 8),
    }


def odd_shapes(rng):
    """Zero-size, scalar and non-contiguous arrays."""
    return {
        "empty": np.zeros((0, 3), np.float32),
        "empty_bool": np.zeros((2, 0, 4), bool),
        "scalar": np.array(3.5, np.float32),
        "strided": rng.normal(size=(64, 48, 3)).astype(np.float32)[:, ::2],
        "transposed": rng.integers(0, 9, (300, 200)).astype(np.int64).T,
        "broadcast": np.broadcast_to(np.eye(4, dtype=np.float32),
                                     (5, 6, 4, 4)),
        "reversed": np.arange(20, dtype=np.int32)[::-1],
    }


@pytest.mark.parametrize("dtype", ["f32", "i32", "i64", "u8", "bool",
                                   "f64"])
def test_each_dtype_is_byte_identical(dtype):
    rng = np.random.default_rng(0)
    a = mixed(rng, 8 * 4099 * 8)[dtype][:4099 * 8].reshape(4099, 8)
    batch = {dtype: a[:, ::-1].copy()}
    assert_same(to_device(batch, CPU), batch)


def test_zero_size_and_scalar_arrays():
    batch = {"a": np.zeros((0, 3), np.float32),
             "b": np.arange(5, dtype=np.int64),
             "c": np.zeros((2, 0, 4), bool),
             "d": np.array(3.5, np.float32),
             "e": np.zeros((0,), np.uint8)}
    got = to_device(batch, CPU)
    assert_same(got, batch)
    assert got["d"].shape == (1,)


def test_array_over_32_mb():
    rng = np.random.default_rng(1)
    n = (32 * MB + 12345) // 4
    batch = {"head": np.arange(3, dtype=np.uint8),
             "big": rng.normal(size=n).astype(np.float32),
             "tail": np.arange(7, dtype=np.int64)}
    assert_same(to_device(batch, CPU), batch)


def test_many_small_arrays():
    rng = np.random.default_rng(2)
    kinds = ["f32", "i32", "i64", "u8", "bool", "f64"]
    batch = {}
    for i in range(300):
        size = int(rng.integers(1, 64 << 10))
        batch[f"k{i:03d}"] = mixed(rng, 8 * (size // 8 + 1))[kinds[i % 6]]
    assert_same(to_device(batch, CPU), batch)


def test_non_contiguous_views():
    rng = np.random.default_rng(3)
    batch = {
        "odd": np.arange(3, dtype=np.uint8),
        "strided": rng.normal(size=(64, 48, 3)).astype(np.float32)[:, ::2],
        "transposed": rng.integers(0, 9, (300, 200)).astype(np.int64).T,
        "broadcast": np.broadcast_to(np.eye(4, dtype=np.float32),
                                     (5, 6, 4, 4)),
        "frame": rng.normal(size=(2, 3, 4, 33, 17, 3)).astype(
            np.float32)[:, 1],
        "rows": rng.normal(size=(4 * MB // 64 + 999, 32)).astype(
            np.float32)[:, ::2],
        "reversed": np.arange(20, dtype=np.int32)[::-1],
        "bool_cols": (rng.uniform(size=(1000, 9)) > 0.5)[:, 1::3],
    }
    assert not any(v.flags.c_contiguous for k, v in batch.items()
                   if k != "odd")
    assert_same(to_device(batch, CPU), batch)


def test_training_batch_keys_shapes_and_dtypes_in_order():
    cfg = tiny_config()
    batch = synthetic_batch(cfg, 2, num_rays=64, seed=5, with_labels=True,
                            with_traj=True)
    assert list(batch)[-4:] == ["ego_states", "temporal_semantics",
                                "temporal_rays", "temporal_trajs"]
    assert_same(to_device(batch, CPU), batch)
    assert_same(to_device(batch, "cpu"), batch)


def test_threads_upload_at_once():
    """16 threads, each uploading its own batches, with a short switch
    interval: every result is its own batch's bytes."""
    rng = np.random.default_rng(7)
    batches = [mixed(rng, 2 * MB + 8 * i) for i in range(16)]
    results = [None] * 16

    def work(i):
        results[i] = [to_device(batches[i], CPU) for _ in range(3)]

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    for batch, outs in zip(batches, results):
        for got in outs:
            assert_same(got, batch)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def hold_stream_busy():
    """Queue ~100 ms of spinning on the current stream, so that copies
    issued after it are still pending when the host goes on."""
    torch.cuda._sleep(200_000_000)


@pytest.mark.card
def test_card_sources_overwritten_after_the_call(card):
    rng = np.random.default_rng(4)
    batch = {**mixed(rng, 8 * MB + 999), **odd_shapes(rng)}
    keep = {k: v.copy() for k, v in batch.items()}
    hold_stream_busy()
    got = to_device(batch, "cuda")
    pending = not torch.cuda.current_stream(card).query()
    for k, v in batch.items():
        if v.flags.writeable:
            v[...] = 0
    del batch
    torch.cuda.synchronize(card)
    assert pending
    assert_same(got, keep, card)


@pytest.mark.card
def test_card_pinned_blocks_reused_behind_pending_copies(card):
    """Five batches of about 16 MB a key, each uploaded and its sources
    overwritten at once; on every other call the stream is first held
    busy, so the copies queue behind it while the pinned blocks of the
    call before have already been freed to the host allocator. Every
    result equals `torch.from_numpy` of its batch as it was."""
    rng = np.random.default_rng(8)
    kept, results, pending = [], [], []
    for i in range(5):
        batch = mixed(rng, 16 * MB + 4097 * i)
        kept.append({k: v.copy() for k, v in batch.items()})
        if i % 2 == 0:
            hold_stream_busy()
        results.append(to_device(batch, "cuda"))
        pending.append(not torch.cuda.current_stream(card).query())
        for v in batch.values():
            v[...] = 0
        del batch
    torch.cuda.synchronize(card)
    assert pending[0] and pending[2] and pending[4]
    for got, keep in zip(results, kept):
        assert_same(got, keep, card)
