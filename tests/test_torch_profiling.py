"""Parity of the port's ``utils.profiling`` with
``mba_tpu/utils/profiling.py``: the stage timer's report text and saved
JSON, and the ``torch.profiler`` trace that ``device_trace`` writes with
the regions ``annotate`` names."""
import json

import numpy as np
import pytest
import torch

from mba_tpu.utils import profiling as JP

from mba_tpu_torch.utils import profiling as TP

torch.set_num_threads(1)

STAGES = [("filtering", 1.25), ("ica fit", 10.5), ("a label longer than "
                                                   "thirty-two chars", 0.004)]


def _timers():
    jt, tt = JP.StageTimer("study"), TP.StageTimer("study")
    jt.stages, tt.stages = list(STAGES), list(STAGES)
    return jt, tt


def test_report_equals_jax():
    jt, tt = _timers()
    printed = []
    assert tt.report(printer=printed.append) == jt.report(printer=None)
    assert printed == [jt.report(printer=None)]
    assert tt.total == jt.total
    empty = TP.StageTimer("none").report(printer=None)
    assert empty == JP.StageTimer("none").report(printer=None)


def test_saved_json_equals_jax(tmp_path):
    jt, tt = _timers()
    pj = jt.save(tmp_path / "jax")
    pt = tt.save(tmp_path / "port")
    assert pt.name.endswith(" Stage Timings study.json")
    assert pt.name[len("YYYY-MM-DD HH_MM_SS"):] == \
        pj.name[len("YYYY-MM-DD HH_MM_SS"):]
    assert json.loads(pt.read_text()) == json.loads(pj.read_text())


def test_stage_and_timed_record_in_order():
    timer = TP.StageTimer("cpu")
    with timer.stage("first", result_getter=lambda: {"x": torch.ones(3)}):
        pass

    @timer.timed("second")
    def work(n):
        return [torch.arange(n), (torch.zeros(2),)]

    out = work(4)
    with timer.stage("third"):
        pass
    assert [lb for lb, _ in timer.stages] == ["first", "second", "third"]
    assert all(t >= 0 for _, t in timer.stages)
    assert torch.equal(out[0], torch.arange(4))


@pytest.mark.parametrize("enabled", [True, False])
def test_device_trace_writes_a_trace_with_annotations(tmp_path, enabled):
    with TP.device_trace(tmp_path, enabled=enabled) as prof:
        with TP.annotate("mba span"):
            torch.ones((64, 64)) @ torch.ones((64, 64))
    files = list(tmp_path.glob("*.json"))
    if not enabled:
        assert prof is None and files == []
        return
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(ev.get("name") == "mba span" for ev in events)


def test_cuda_devices_of_a_result():
    assert TP._cuda_devices({"a": [torch.ones(1), (np.ones(1),)]}) == set()
