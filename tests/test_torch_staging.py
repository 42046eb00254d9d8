"""The staged upload (``mba_tpu_torch._staging`` under
``_device.upload``/``to_device``).

On the CPU: the ring's chunk plan (every byte once and in order; no
buffer handed out before the chunk that last read it) and its threads'
share of it, the staging run on host buffers with stand-in events, and
the plain path that arrays under the threshold, tensors and the CPU
keep, bit for bit and counted as nothing staged.
Marked ``cuda``: the staged upload on the card, bit for bit for float32,
int16 and int8, C-contiguous and strided, the caller's array left as it
was, the ring reused across calls, and the copy's event ordering a
consumer stream.  This file imports no JAX: on a card,

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_staging.py
"""
import numpy as np
import pytest
import torch

from mba_tpu_torch import _device, _staging
from mba_tpu_torch.utils.profiling import recording

CHUNK = _staging.CHUNK_BYTES
PER_THREAD = _staging.BUFFERS_PER_THREAD


# ---- the chunk plan and the threads' share of it -----------------------

@pytest.mark.parametrize("nbytes", [0, 1, CHUNK, CHUNK + 1, 7 * CHUNK + 5,
                                    3 * 16 * CHUNK])
@pytest.mark.parametrize("cursor", [0, 3, 1001])
def test_plan_covers_every_byte_once_in_order(nbytes, cursor):
    depth = PER_THREAD * 8
    plan = _staging.chunk_plan(nbytes, CHUNK, depth, cursor)
    assert len(plan) == -(-nbytes // CHUNK)
    starts = [s.start for s in plan] + [nbytes]
    assert starts[0] == 0
    for step, nxt in zip(plan, starts[1:]):
        assert step.stop == nxt and 0 < step.stop - step.start <= CHUNK
    assert [s.slot for s in plan] == [(cursor + i) % depth
                                      for i in range(len(plan))]


@pytest.mark.parametrize("n_threads", [1, 3, 8])
def test_no_buffer_is_handed_out_before_its_last_chunk(n_threads):
    """Plans one after another, as the ring runs them (its count carried
    over), dealt to the threads: a buffer is handed out again only
    ``depth`` chunks after its last chunk, every buffer belongs to one
    thread, and that thread takes the buffer's chunks in order, so it
    waits for its own transfer from the buffer before it refills it."""
    depth = PER_THREAD * n_threads
    last, owner = {}, {}
    cursor = 0
    for nbytes in (3 * CHUNK + 1, 1, CHUNK, 0, 9 * CHUNK, 2, 40 * CHUNK):
        plan = _staging.chunk_plan(nbytes, CHUNK, depth, cursor)
        for seq, step in enumerate(plan, start=cursor):
            assert 0 <= step.slot < depth
            assert last.get(step.slot, seq - depth) == seq - depth
            last[step.slot] = seq
        lanes = _staging.lanes(list(enumerate(plan, start=cursor)),
                               n_threads)
        assert len(lanes) == min(n_threads, len(plan))
        assert sorted(seq for lane in lanes for seq, _ in lane) == \
            list(range(cursor, cursor + len(plan)))
        for lane in lanes:
            seqs = [seq for seq, _ in lane]
            assert seqs == sorted(seqs)
            for seq, step in lane:
                assert owner.setdefault(step.slot, seq % n_threads) == \
                    seq % n_threads
        cursor += len(plan)


class _Event:
    """A stand-in for a CUDA event: logs its records and waits."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def record(self, stream=None):
        self.log.append(("record", self.name))

    def synchronize(self):
        self.log.append(("wait", self.name))


@pytest.mark.parametrize("n_threads", [1, 3])
def test_stage_runs_on_host_buffers(monkeypatch, n_threads):
    """The staging itself with host buffers for the pinned ones and
    logging stand-ins for the events (a copy to a CPU tensor is done when
    it returns): the arrays arrive bit for bit in their type and shape,
    the caller's arrays are left as they were, every buffer is waited on
    before each refill after the record of its last transfer, and the
    ready event is recorded last."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    chunk = 4096
    log = []
    monkeypatch.setattr(_staging, "CHUNK_BYTES", chunk)
    monkeypatch.setattr(_staging, "threads", lambda: n_threads)
    pool = ThreadPoolExecutor(n_threads)
    monkeypatch.setattr(_staging, "_pool", lambda: pool)
    monkeypatch.setattr(torch.cuda, "Event", lambda: _Event(log, "ready"))
    r = object.__new__(_staging._Ring)
    r.depth = PER_THREAD * n_threads
    r.stream = None
    r.buffers = [torch.zeros(chunk, dtype=torch.uint8)
                 for _ in range(r.depth)]
    r.views = [b.numpy() for b in r.buffers]
    r.events = [_Event(log, s) for s in range(r.depth)]
    r.cursor = 0
    r.lock = threading.Lock()
    monkeypatch.setattr(_staging, "ring", lambda device: r)
    rng = np.random.default_rng(7)
    arrays = [rng.standard_normal((9, 1000), dtype=np.float32),
              rng.integers(-2**15, 2**15, (3, 7001), dtype=np.int16),
              rng.integers(-128, 128, 5 * chunk, dtype=np.int8),
              np.zeros(0, np.float32)]
    before = [a.copy() for a in arrays]
    for _ in range(2):                  # the ring's count carried over
        out, ready = _staging.stage(arrays, torch.device("cpu"))
        for t, a, b in zip(out, arrays, before):
            assert t.dtype == torch.from_numpy(a).dtype
            assert tuple(t.shape) == a.shape
            assert np.array_equal(t.numpy().view(np.uint8),
                                  a.view(np.uint8))
            assert np.array_equal(a, b)
    assert r.cursor == 2 * sum(-(-a.nbytes // chunk) for a in arrays)
    for slot in range(r.depth):
        mine = [kind for kind, name in log if name == slot]
        assert mine == ["wait", "record"] * (len(mine) // 2)
    assert log[-1] == ("record", "ready")
    pool.shutdown()


# ---- the plain path ----------------------------------------------------

def _never_staged(monkeypatch):
    def stage(*a, **k):
        raise AssertionError("staged")
    monkeypatch.setattr(_staging, "stage", stage)


def _big(dtype=np.float32):
    n = _device.STAGE_MIN_BYTES // np.dtype(dtype).itemsize + 6
    return np.random.default_rng(0).standard_normal(n).astype(dtype)


@pytest.mark.parametrize("make", [
    lambda: _big(), lambda: _big(np.int16)[::3],
    lambda: _big(np.float64).reshape(2, -1)])
def test_the_cpu_takes_the_plain_path_bit_for_bit(monkeypatch, make):
    _never_staged(monkeypatch)
    x = make()
    want = torch.from_numpy(np.ascontiguousarray(
        x if x.dtype in (np.float32, np.int16) else x.astype(np.float32)))
    with recording() as rec:
        got = _device.to_device(x, torch.device("cpu"))
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert rec.counters == {}                    # nothing counted off-card


def test_a_contiguous_array_is_shared_on_the_cpu_as_before(monkeypatch):
    _never_staged(monkeypatch)
    x = _big()
    got = _device.to_device(x, torch.device("cpu"))
    assert got.data_ptr() == x.ctypes.data       # no copy, as before


def test_a_tensor_takes_the_plain_path(monkeypatch):
    _never_staged(monkeypatch)
    t = torch.from_numpy(_big())
    up = _device.upload([t], torch.device("cpu"))
    assert up.ready is None and up.take()[0] is t
    with recording() as rec:
        _device.upload([t.double()], torch.device("cpu"))
    assert rec.counters == {}


def test_only_host_arrays_at_the_threshold_are_staged_on_a_card(monkeypatch):
    """The routing on a CUDA device, the copies faked: arrays of at least
    ``STAGE_MIN_BYTES`` (after the cast to float32) to the ring, smaller
    ones and tensors to ``Tensor.to``; both counted where host arrays."""
    staged, plain = [], []

    def stage(arrays, device):
        staged.extend(a.nbytes for a in arrays)
        return [torch.from_numpy(a) for a in arrays], "ready"

    def to(self, device):
        plain.append(self.numel() * self.element_size())
        return self
    monkeypatch.setattr(_staging, "stage", stage)
    monkeypatch.setattr(torch.Tensor, "to", to)
    edge = _device.STAGE_MIN_BYTES
    arrays = [np.zeros(edge // 4, np.float32), np.zeros(edge // 4 - 1,
                                                        np.float32),
              np.zeros(edge // 4, np.float64), np.zeros(edge, np.int8),
              torch.zeros(edge)]
    with recording() as rec:
        up = _device.upload(arrays, torch.device("cuda"))
    assert staged == [edge, edge, edge] and up.ready == "ready"
    assert plain == [edge - 4, 4 * edge]
    assert [tuple(t.shape) for t in up.tensors] == \
        [(edge // 4,), (edge // 4 - 1,), (edge // 4,), (edge,), (edge,)]
    assert rec.counters == {"upload.bytes": 4 * edge - 4,
                            "upload.staged_bytes": 3 * edge}


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the staged upload copies to it")
    return torch.device("cuda")


def _signal(dtype, nbytes):
    rng = np.random.default_rng(3)
    n = nbytes // np.dtype(dtype).itemsize
    if dtype == np.float32:
        x = rng.standard_normal(n, dtype=np.float32)
        x[::997] = np.nan                         # every bit pattern kept
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max + 1, n, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int8])
@pytest.mark.parametrize("layout", ["contiguous", "strided", "transposed"])
def test_staged_upload_is_bit_for_bit(cuda, dtype, layout):
    x = _signal(dtype, 5 * CHUNK + 12_288).reshape(-1, 64)
    if layout == "strided":
        x = x[:, ::2]
    elif layout == "transposed":
        x = x.T
    with recording() as rec:
        got = _device.to_device(x, cuda)
    assert rec.counters["upload.staged_bytes"] == x.nbytes
    want = torch.from_numpy(np.ascontiguousarray(x))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
def test_the_callers_array_is_left_as_it_was(cuda):
    x = _signal(np.float32, 3 * CHUNK + 160).reshape(-1, 8)
    before = x.copy()
    up = _device.upload([x], cuda)
    x[:] = 7.0                     # the caller's array is its own again
    got = up.take()[0].cpu()
    assert np.array_equal(got.numpy().view(np.uint32),
                          before.view(np.uint32))
    x[:] = before
    _device.to_device(x, cuda)
    assert np.array_equal(x.view(np.uint32), before.view(np.uint32))


@pytest.mark.cuda
def test_the_ring_is_reused_across_calls(cuda):
    x = _signal(np.float32, 2 * CHUNK)
    _device.to_device(x, cuda)
    ring = _staging.ring(cuda)
    ptrs = [b.data_ptr() for b in ring.buffers]
    cursor = ring.cursor
    for _ in range(3):
        _device.to_device(x, cuda)
    assert _staging.ring(cuda) is ring
    assert [b.data_ptr() for b in ring.buffers] == ptrs
    assert all(b.is_pinned() for b in ring.buffers)
    assert ring.cursor == cursor + 3 * 2


@pytest.mark.cuda
def test_the_consumer_stream_waits_for_the_copy(cuda):
    """A consumer on a busy stream of its own reads the staged bytes
    only after the copy's event, and the allocator keeps them for it: a
    second staged upload may not take their memory before the consumer
    has read them."""
    rng = np.random.default_rng(4)
    x, y = (rng.standard_normal(6 * CHUNK // 4, dtype=np.float32)
            for _ in range(2))
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)            # ~0.1 s of a busy stream
        t = _device.to_device(x, cuda)
        doubled = t * 2
        del t
        t2 = _device.to_device(y, cuda)
    side.synchronize()
    assert torch.equal(doubled.cpu(), torch.from_numpy(x) * 2)
    assert torch.equal(t2.cpu(), torch.from_numpy(y))
