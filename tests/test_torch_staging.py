"""The staged upload (``mba_tpu_torch._staging`` under
``_device.upload``/``to_device``).

On the CPU: the ring's chunk plan (every byte once and in order; no
buffer handed out before the chunk that last read it), its row plan for
a column selection (every row once, whole rows a chunk) and its threads'
share of it, the staging run on host buffers with stand-in events,
whole arrays and gathered columns alike, the plain path that arrays
under the threshold, tensors and the CPU keep, bit for bit and counted
as nothing staged, and a column selection there as ``np.take``'s.
Marked ``cuda``: the staged upload on the card, bit for bit for float32,
int16 and int8, C-contiguous and strided, the staged gather bit for bit
``np.take``'s, the caller's array left as it was, the ring reused across
calls, and the copy's event ordering a consumer stream.  This file imports no JAX: on a card,

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


@pytest.mark.parametrize("n_cols,dtype", [(1, np.float32), (11, np.float32),
                                          (64, np.float32), (11, np.int16)])
@pytest.mark.parametrize("multiple", [True, False])
@pytest.mark.parametrize("cursor", [0, 1001])
def test_row_plan_covers_every_row_once_in_whole_rows(n_cols, dtype,
                                                      multiple, cursor):
    """A gathered array's plan: every row once and in order, each chunk
    the most whole rows whose selected columns fit a buffer (the last
    one fewer where the rows are no multiple of that), the buffers
    handed out as in the byte plan."""
    depth = PER_THREAD * 8
    row_bytes = n_cols * np.dtype(dtype).itemsize
    per_chunk = CHUNK // row_bytes
    n_rows = 3 * per_chunk + (0 if multiple else 17)
    plan = _staging.row_plan(n_rows, row_bytes, CHUNK, depth, cursor)
    assert len(plan) == 3 + (not multiple)
    assert [s.start for s in plan] == list(range(0, n_rows, per_chunk))
    assert [s.stop - s.start for s in plan] == \
        [per_chunk] * 3 + ([] if multiple else [17])
    assert plan[-1].stop == n_rows
    assert all((s.stop - s.start) * row_bytes <= CHUNK for s in plan)
    assert [s.slot for s in plan] == [(cursor + i) % depth
                                      for i in range(len(plan))]
    if (n_cols, dtype) == (11, np.float32):
        assert per_chunk == 190_650              # the task CMC's subset


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
              np.zeros(0, np.float32),
              rng.standard_normal((1001, 64), dtype=np.float32),
              rng.integers(-2**15, 2**15, (999, 16), dtype=np.int16),
              rng.integers(-128, 128, (3000, 7), dtype=np.int8),
              np.zeros((0, 64), np.float32)]
    arrays[4][::7, 3] = np.nan                    # every bit pattern kept
    # whole arrays, then selections: sorted, unsorted and repeated,
    # one column, one column repeated past the array's width
    columns = [None] * 4 + [np.array([3, 4, 9, 63]),
                            np.array([15, 0, 7, 7, 2]), np.array([6]),
                            np.array([1] * 70)]
    want = [a if c is None else np.take(a, c, axis=1)
            for a, c in zip(arrays, columns)]
    before = [a.copy() for a in arrays]
    for _ in range(2):                  # the ring's count carried over
        out, ready = _staging.stage(arrays, torch.device("cpu"), columns)
        for t, a, w, b in zip(out, arrays, want, before):
            assert t.dtype == torch.from_numpy(a).dtype
            assert tuple(t.shape) == w.shape
            assert np.array_equal(t.numpy().view(np.uint8),
                                  w.view(np.uint8))
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert r.cursor == 2 * sum(-(-w.nbytes // chunk) if c is None
                               else -(-len(w) // (chunk // w[0].nbytes))
                               for w, c in zip(want, columns) if w.size)
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

    def stage(arrays, device, columns):
        assert columns == [None] * len(arrays)
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


_PICKS = {"sorted": [4, 7, 9], "unsorted, repeated": [9, 4, 4, 63, 0],
          "negative": [-1, 2, -64], "array": np.array([[5], [6]])[:, 0]}


@pytest.mark.parametrize("pick", list(_PICKS))
@pytest.mark.parametrize("make", [
    lambda: _big()[:64 * 4000].reshape(-1, 64),
    lambda: _big(np.float64)[:64 * 999].reshape(-1, 64),
    lambda: _big(np.int16)[:64 * 3000].reshape(-1, 64)[::2],
    lambda: np.asfortranarray(_big()[:64 * 500].reshape(-1, 64)),
    lambda: torch.from_numpy(_big()[:64 * 700].reshape(-1, 64))])
def test_a_selection_on_the_cpu_is_np_take(monkeypatch, make, pick):
    """On the CPU a column selection is made before the upload, as
    ``np.take(x, cols, axis=1)`` (``x[:, cols]`` for a tensor), then cast
    and copied as any array: the same values and type, and only
    ``upload.subset_bytes`` counted."""
    _never_staged(monkeypatch)
    x, cols = make(), _PICKS[pick]
    if isinstance(x, torch.Tensor):
        want = x[:, cols]
    else:
        want = np.take(x, cols, axis=1)
        want = torch.from_numpy(np.ascontiguousarray(
            want if want.dtype != np.float64 else want.astype(np.float32)))
    with recording() as rec:
        got = _device.to_device(x, torch.device("cpu"), cols)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert rec.counters == {"upload.subset_bytes":
                            want.numel() * want.element_size()}


def test_only_selections_the_ring_can_take_are_gathered_on_a_card(
        monkeypatch):
    """The routing of column selections on a CUDA device, the copies
    faked: the ring gathers the selection of a C-contiguous 2-D host
    array of a staged type, from the caller's array, where it is of at
    least ``STAGE_MIN_BYTES``; every other selection (smaller, of a
    tensor, a float64 or a Fortran-ordered array) is made first, as on
    the CPU, and uploaded as any array, staged or plain.  Every
    selection is counted, and on the host those gathered."""
    staged, plain = [], []

    def stage(arrays, device, columns):
        staged.extend((a, c) for a, c in zip(arrays, columns))
        return [torch.from_numpy(a if c is None else np.take(a, c, axis=1))
                for a, c in zip(arrays, columns)], "ready"

    def to(self, device):
        plain.append(self.numel() * self.element_size())
        return self
    monkeypatch.setattr(_staging, "stage", stage)
    monkeypatch.setattr(torch.Tensor, "to", to)
    edge = _device.STAGE_MIN_BYTES
    rows = edge // (4 * 4)                    # 4 float32 columns: the edge
    wide = np.zeros((rows, 64), np.float32)
    cols = [3, 1, 1, -2]
    arrays = [wide, wide[:rows - 1], torch.from_numpy(wide),
              wide.astype(np.float64), np.asfortranarray(wide), wide]
    with recording() as rec:
        up = _device.upload(arrays, torch.device("cuda"),
                            [cols] * 5 + [None])
    gathered = [(a, c) for a, c in staged if c is not None]
    assert len(gathered) == 1 and gathered[0][0] is wide
    assert list(gathered[0][1]) == [3, 1, 1, 62]
    assert [a.nbytes for a, c in staged if c is None] == \
        [edge, edge, wide.nbytes]     # float64 and Fortran, after np.take
    assert plain == [edge - 16, edge]            # smaller; the tensor's
    assert [tuple(t.shape) for t in up.tensors] == \
        [(rows, 4), (rows - 1, 4), (rows, 4), (rows, 4), (rows, 4),
         (rows, 64)]
    assert rec.counters == {
        "upload.subset_bytes": 5 * edge - 16,
        "upload.gathered_bytes": edge,
        "upload.bytes": 4 * edge - 16 + wide.nbytes,
        "upload.staged_bytes": 3 * edge + wide.nbytes}


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


# 11 of 64 columns, as the task CMC's subset: in order; unsorted with
# repeats
_COLUMNS = {"columns": [4, 7, 9, 13, 15, 17, 19, 32, 34, 36, 38],
            "columns unsorted": [38, 4, 4, 63, 0, 17, 9, 9, 1, 60, 33]}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int8])
@pytest.mark.parametrize("layout", ["contiguous", "strided", "transposed",
                                    *_COLUMNS])
def test_staged_upload_is_bit_for_bit(cuda, dtype, layout):
    """Whole arrays of every layout, and column selections gathered by
    the ring (2.6 chunks of selected bytes), bit for bit."""
    cols = _COLUMNS.get(layout)
    if cols is None:
        x = _signal(dtype, 5 * CHUNK + 12_288).reshape(-1, 64)
        if layout == "strided":
            x = x[:, ::2]
        elif layout == "transposed":
            x = x.T
        want = np.ascontiguousarray(x)
    else:
        size = np.dtype(dtype).itemsize
        rows = int(2.6 * CHUNK) // (len(cols) * size)
        x = _signal(dtype, rows * 64 * size).reshape(rows, 64)
        want = np.take(x, cols, axis=1)
    with recording() as rec:
        got = _device.to_device(x, cuda, cols)
    assert rec.counters["upload.staged_bytes"] == want.nbytes
    if cols is not None:
        assert rec.counters["upload.gathered_bytes"] == \
            rec.counters["upload.subset_bytes"] == want.nbytes
    want = torch.from_numpy(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8))


@pytest.mark.cuda
def test_a_gather_beside_whole_arrays_in_one_call(cuda):
    """Selections and whole arrays in one ``stage`` call, twice: each
    arrives bit for bit, and the ring's count carries across the calls,
    each array's chunks (rows or bytes) counted once."""
    ring = _staging.ring(cuda)
    xs = [_signal(np.float32, 3 * CHUNK + 4096).reshape(-1, 64),
          _signal(np.int16, 2 * CHUNK).reshape(-1, 64),
          _signal(np.int8, CHUNK + 640).reshape(-1, 64)]
    # 48 columns in falling order, one twice: 3 chunks; 2 columns: 1
    cols = [np.r_[63:16:-1, 20], None, np.array([63, 1])]
    want = [x if c is None else np.take(x, c, axis=1)
            for x, c in zip(xs, cols)]
    n_chunks = 3 + 2 + 1
    for _ in range(2):
        cursor = ring.cursor
        out, ready = _staging.stage(xs, cuda, cols)
        ready.synchronize()
        assert ring.cursor == cursor + n_chunks
        for t, w in zip(out, want):
            assert tuple(t.shape) == w.shape
            assert np.array_equal(t.cpu().numpy().view(np.uint8),
                                  w.view(np.uint8))


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
