"""The readers of the program's own spans and counters
(``metrics/_program.py`` and the five metrics on it) on synthetic runs:
each call's records placed on its clock, the rates, shares and the
device time inside the upload spans; nothing read from a program that
records nothing; and idle device time named by the program's ranges in
a synthetic trace."""
import pytest

from benchmarks.harness.catalog import Catalog
from benchmarks.harness.trace import summarize
from benchmarks.metrics._program import placed

CAT = Catalog()
NEW = ("cmc.scatter_s", "cmc.download_gbps", "null.upload_gbps",
       "null.upload_overlap_share", "null.coeffs_useful_share")


def _read(metric, run):
    return CAT.reader(metric).read(run)


def _null_call(returned_s, uploads, framed=1536, weighted=660,
               n_bytes=2_000_000_000):
    """A null call whose root ends at 2.0 s and returns at ``returned_s``
    (s from the call's start), with upload spans ``uploads`` [start, end]
    on the root's clock."""
    recs = [["null", -1, 0.0, 2.0], ["null.plan", 0, 0.0, 0.01]]
    recs += [["null.upload", 0, a, b] for a, b in uploads]
    return {"wall_s": returned_s + 0.001, "returned_s": returned_s,
            "spans": {"upload_sec": sum(b - a for a, b in uploads),
                      "upload_bytes": n_bytes, "spans": recs,
                      "counters": {"coeffs.windows_framed": framed,
                                   "coeffs.windows_weighted": weighted}}}


def _null_run(trace=None):
    return {"calls": [_null_call(2.5, [[0.1, 0.6], [0.8, 1.3]]),
                      _null_call(2.0, [[0.0, 1.0]], framed=1344)],
            "trace": trace, "work": {}}


def test_records_are_placed_by_the_call_return():
    call = _null_run()["calls"][0]
    # the root ends at 2.0 s on its clock, the call returned at 2.5 s
    got = placed(call, call["spans"]["spans"], "null.upload")
    assert [x for iv in got for x in iv] == pytest.approx(
        [0.6, 1.1, 1.3, 1.8])


def test_upload_rate_and_useful_share():
    run = _null_run()
    # 4 GB over 1.0 + 1.0 s of spans
    assert _read("null.upload_gbps", run) == pytest.approx(2.0)
    assert _read("null.coeffs_useful_share", run) == pytest.approx(
        100 * 1320 / (1536 + 1344))
    one = {"calls": run["calls"][:1]}
    assert _read("null.coeffs_useful_share", one) == pytest.approx(
        100 * 660 / 1536)                         # 42.97 %


def test_upload_overlap_on_the_calls_clock():
    # kernel intervals per call, s from the call's start: the first
    # call's uploads lie at [0.6, 1.1] and [1.3, 1.8], the second's at
    # [0.0, 1.0]
    trace = {"calls": [[[0.5, 0.7], [1.0, 1.4]],          # 0.1 + 0.1 + 0.1
                       [[1.0, 2.0]]]}                     # touches only
    share = _read("null.upload_overlap_share", _null_run(trace))
    assert share == pytest.approx(100 * 0.3 / 2.0)
    trace = {"calls": [[], []]}
    assert _read("null.upload_overlap_share", _null_run(trace)) == 0.0
    assert _read("null.upload_overlap_share", _null_run(None)) is None
    miscounted = {"calls": [[[0.0, 1.0]]]}
    assert _read("null.upload_overlap_share", _null_run(miscounted)) is None


def test_cmc_scatter_and_download():
    def call(scatter, download, n_bytes):
        recs = [["cmc", -1, 0.0, 0.3], ["cmc.download", 0, 0.1, 0.1
                                         + download],
                ["cmc.scatter", 0, 0.2, 0.2 + scatter]]
        return {"wall_s": 0.3, "returned_s": 0.3,
                "spans": {"spans": recs, "download_bytes": n_bytes,
                          "counters": {}}}
    run = {"calls": [call(0.08, 0.04, 187_000_000),
                     call(0.10, 0.06, 187_000_000)], "trace": None}
    assert _read("cmc.scatter_s", run) == pytest.approx(0.09)
    assert _read("cmc.download_gbps", run) == pytest.approx(
        2 * 0.187 / 0.10)


@pytest.mark.parametrize("spans", [
    {},                                            # an untraced CMC call
    {"upload_sec": 3.5, "coeffs_sec": 1.4,         # a program that keeps
     "upload_bytes": 21_400_000_000},              # only its timings
])
@pytest.mark.parametrize("metric", NEW)
def test_nothing_read_without_records(metric, spans):
    run = {"calls": [{"wall_s": 1.0, "returned_s": 1.0, "spans": spans}],
           "trace": {"calls": [[[0.0, 1.0]]]}, "work": {}}
    assert _read(metric, run) is None


@pytest.mark.parametrize("metric", NEW)
def test_a_call_without_records_reads_nothing(metric):
    """One call of the window without records (a failed call) and the
    metric is not read from the others."""
    run = _null_run({"calls": [[], [], []]})
    cmc = {"spans": [["cmc", -1, 0.0, 0.3], ["cmc.scatter", 0, 0.1, 0.2],
                     ["cmc.download", 0, 0.0, 0.1]],
           "download_bytes": 1}
    for c in run["calls"]:
        c["spans"].update(cmc)
    run["calls"].append({"wall_s": 1.0, "returned_s": 1.0, "spans": {}})
    assert _read(metric, run) is None


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_idle_gap_named_by_a_program_span():
    """A CMC call (µs): a kernel at 0-200, then the program's scatter on
    the host at 300-900 with the card idle, an aten op at 950-980 inside
    the root span alone."""
    events = [
        _ev("bench.window", "user_annotation", 0, 1_000),
        _ev("bench.call", "user_annotation", 0, 1_000),
        _ev("cmc", "user_annotation", 10, 980),
        _ev("cmc.download", "user_annotation", 20, 200),
        _ev("k", "kernel", 0, 200, tid=7),
        _ev("cmc.scatter", "user_annotation", 300, 600),
        _ev("aten::empty", "cpu_op", 950, 30),
    ]
    gaps = dict(summarize(events)["idle_gaps"])
    assert gaps["bench.call > cmc.scatter"] == pytest.approx(600e-6)
    assert gaps["bench.call > aten::empty"] == pytest.approx(30e-6)
    # 200-220 in the download, 220-300, 900-950 and 980-990 in the root
    assert gaps["bench.call > cmc.download"] == pytest.approx(20e-6)
    assert gaps["bench.call > cmc"] == pytest.approx(140e-6)
    assert gaps["bench.call > python"] == pytest.approx(10e-6)


def test_new_metrics_listed_in_the_cells_that_report_them():
    for cell in ("cohort12.null_default", "cohort12.null_coeff_b3"):
        names = {m["name"] for m in CAT.per_layer(cell)}
        assert {"null.upload_gbps", "null.upload_overlap_share",
                "null.coeffs_useful_share"} <= names
        assert not {"cmc.scatter_s", "cmc.download_gbps"} & names
    names = {m["name"] for m in CAT.per_layer("subject64.cmc_120s")}
    assert {"cmc.scatter_s", "cmc.download_gbps"} <= names
