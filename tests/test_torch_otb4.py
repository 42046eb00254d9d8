"""The port's OTB4 import (``io.otb4``, a host copy) and the OTB4 import
workflow against ``mba_tpu`` on the CPU.

An archive written by either package's ``write_otb4`` reads back through
the other's ``read_otb4`` as through its own: the same ADC counts and
per-channel mV factors (``raw_counts=True``), the same float32 mV, the
same metadata, all equal.  The reader is also held on the multi-track
int16 and the Novecento+ int32 archives of ``tests/test_utils_io.py``;
the CSV export and ``import_subject``'s ``.npy`` files are the JAX
package's, byte for byte.
"""
import contextlib
import io
import shutil

import numpy as np
import pytest

from mba_tpu.io import otb4 as J
from mba_tpu.workflows import otb4_import_workflow as JW
from mba_tpu_torch.io import otb4 as T
from mba_tpu_torch.workflows import otb4_import_workflow as TW

from _torch_study import assert_same
from test_utils_io import _make_otb4, _make_otb4_novecento

PACKAGES = {"port": T, "jax": J}


def _recording(kind, n_ch=6, n=500, seed=5):
    rng = np.random.default_rng(seed)
    if kind == "counts":
        return rng.integers(-30000, 30000, size=(n_ch, n), dtype=np.int16)
    return (rng.standard_normal((n_ch, n)) * 5.0).astype(np.float32)


@pytest.mark.parametrize("raw_counts", [True, False])
@pytest.mark.parametrize("kind", ["counts", "mv"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_written_archive_reads_back_through_both(tmp_path, writer, kind,
                                                 raw_counts):
    data = _recording(kind)
    path = PACKAGES[writer].write_otb4(tmp_path / "rec.otb4", data, 2048.0,
                                       gain=2.0, adc_range=2.4)
    got = T.read_otb4(path, raw_counts=raw_counts)
    want = J.read_otb4(path, raw_counts=raw_counts)
    assert_same(got, want)
    _, signal, fs = got["signals"][0]
    assert fs == 2048 and signal.shape == data.shape
    if raw_counts:
        assert signal.dtype == np.int16
        if kind == "counts":
            np.testing.assert_array_equal(signal, data)


@pytest.mark.parametrize("kind", ["counts", "mv"])
def test_both_writers_write_the_same_archive(tmp_path, kind):
    data = _recording(kind, seed=6)
    parsed = []
    for name, mod in PACKAGES.items():
        path = mod.write_otb4(tmp_path / f"{name}.otb4", data, 1000.0,
                              device="Quattrocento", gain=1.0,
                              adc_nbits=16, adc_range=2.4)
        parsed.append(J.read_otb4(path, raw_counts=True))
    assert_same(parsed[0], parsed[1])


@pytest.mark.parametrize("raw_counts", [True, False])
@pytest.mark.parametrize("layout", ["multitrack_int16", "novecento_int32"])
def test_reader_matches_jax_on_other_layouts(tmp_path, layout, raw_counts):
    make = {"multitrack_int16": _make_otb4,
            "novecento_int32": _make_otb4_novecento}[layout]
    path = tmp_path / "rec.otb4"
    make(path)
    outs = []
    for mod in (T, J):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            outs.append((mod.read_otb4(path, verbose=True,
                                       raw_counts=raw_counts),
                         buf.getvalue()))
    assert_same(outs[0][0], outs[1][0])
    assert outs[0][1] == outs[1][1]


@pytest.mark.parametrize("combine", [True, False])
def test_csv_export_matches_jax(tmp_path, combine):
    path = tmp_path / "rec.otb4"
    _make_otb4(path, n_tracks=3, n_ch_per=4)
    results = {}
    for name, mod in PACKAGES.items():
        out_dir = tmp_path / name
        res = mod.import_otb4_to_csv(str(path), str(out_dir),
                                     output_title="subject_00_grid",
                                     combine_channels=combine,
                                     channel_range=(2, 9), verbose=False)
        files = [p for p in res.pop("output_files")]
        results[name] = (res, [(f.split("/")[-1], open(f).read())
                               for f in files])
    assert_same(results["port"], results["jax"])
    assert len(results["port"][1]) == (1 if combine else 7)


def test_errors_match_jax(tmp_path):
    path = tmp_path / "rec.otb4"
    _make_otb4(path)
    bad = tmp_path / "not_a_tar.otb4"
    bad.write_bytes(b"nothing here")
    calls = [lambda m: m.read_otb4(tmp_path / "missing.otb4"),
             lambda m: m.read_otb4(bad),
             lambda m: m.import_otb4_to_csv(str(path), str(tmp_path / "o"),
                                            channel_range=(0, 99),
                                            verbose=False),
             lambda m: m.write_otb4(tmp_path / "x.otb4", np.zeros(5),
                                    2048.0)]
    for call in calls:
        raised = []
        for mod in (T, J):
            with pytest.raises(Exception) as info:
                call(mod)
            raised.append((type(info.value), str(info.value)))
        assert raised[0] == raised[1]


@pytest.mark.parametrize("swap", [False, True])
def test_import_subject_matches_jax(tmp_path, swap):
    """``import_subject`` on one 192-channel archive: the same CSVs and
    the same "Raw … 64ch" ``.npy`` files as the JAX package's."""
    rng = np.random.default_rng(7)
    counts = rng.integers(-3000, 3000, size=(192, 300), dtype=np.int16)
    path = J.write_otb4(tmp_path / "subject.otb4", counts, 2048.0)
    outputs = {}
    for name, mod in (("port", TW), ("jax", JW)):
        feat = tmp_path / name
        mod.import_subject(path, feat, subject=3, swap_emg_grids=swap)
        outputs[name] = sorted((p.name[20:] if p.suffix == ".npy"
                                else p.name, p.read_bytes())
                               for p in feat.iterdir())
    assert [n for n, _ in outputs["port"]] == [n for n, _ in outputs["jax"]]
    assert outputs["port"] == outputs["jax"]
    npys = [n for n, _ in outputs["port"] if n.endswith(".npy")]
    assert npys == ["Raw eeg 64ch.npy", "Raw emg_1_flexor 64ch.npy",
                    "Raw emg_2_extensor 64ch.npy"]
    flexor = np.load(next((tmp_path / "port").glob("*emg_1_flexor*.npy")))
    start = 128 if swap else 64
    np.testing.assert_allclose(
        flexor, (counts[start:start + 64].T.astype(np.float32)
                 * np.float32(2.4 / 2 ** 16 * 1000.0)), rtol=1e-6)


def test_show_graph_draws_as_jax(tmp_path):
    """The preview plot (matplotlib, imported only to draw) saves one
    figure from either package."""
    path = tmp_path / "rec.otb4"
    _make_otb4(path)
    names = {}
    for name, mod in PACKAGES.items():
        out = tmp_path / f"fig_{name}"
        mod.show_graph(str(path), channels=[0, 2], save_dir=out)
        names[name] = sorted(p.name[20:] for p in out.iterdir())
    assert names["port"] == names["jax"] and len(names["port"]) == 1
    shutil.rmtree(tmp_path / "fig_port")
