"""Rules of the ``mba_tpu_torch`` package, and its kernels on the card.

The unmarked tests run anywhere: the package imports neither JAX nor
``mba_tpu``; a CPU tensor reaches each kernel's plain version and leaves
its launch count alone; the wrappers refuse what their kernels do not
take; the build command targets ``sm_90a`` without fast math.

The tests marked ``cuda`` compare each hand-written kernel with its plain
version on an NVIDIA card and skip without one.  This file imports no
JAX, so on a machine with a card and without JAX it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_package.py
"""
import importlib
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import mba_tpu_torch
from mba_tpu_torch import _build
from mba_tpu_torch.ops import cohort_null as TN
from mba_tpu_torch.ops import coherence as TC
from mba_tpu_torch.ops import ica as TI
from mba_tpu_torch.ops import cuda_coeffs, cuda_msc, cuda_null, cuda_prng
from mba_tpu_torch.ops import prng
from mba_tpu_torch.ops import spectral as TS
from mba_tpu_torch.ops import surrogate as TSu
from mba_tpu_torch.ops.dpss import filtered_tapers
from mba_tpu_torch.ops.framing import (frame_signal, resample_linear,
                                       window_grid)
from mba_tpu_torch.models import lme as TL
from mba_tpu_torch.ops import permutation as TPerm
from mba_tpu_torch.pipeline import signal_features as TF
from mba_tpu_torch.pipeline.cbpa import CMC_EEG_CHANNEL_SUBSET

from _torch_parity import (MSC_MASKS, MSC_OPTIONS, MSC_TRANSFERS,
                           check_msc_assembly, cohort_subject,
                           coupled_signals, null_toy, t32)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
KEYS = ("coherence", "ci_lower", "ci_upper")


def _module_names():
    names = ["mba_tpu_torch"]
    for info in pkgutil.walk_packages(mba_tpu_torch.__path__,
                                      "mba_tpu_torch."):
        names.append(info.name)
    return names


def _spectra(seed, W, ws, nE, nM, device="cpu", nw=3):
    """Tapered rFFT spectra of frames that share a common drive."""
    rng = np.random.default_rng(seed)
    shared = rng.standard_normal((W, ws, 1))
    eeg = (0.6 * shared + rng.standard_normal((W, ws, nE))).astype(np.float32)
    emg = (0.6 * shared + rng.standard_normal((W, ws, nM))).astype(np.float32)
    tapers = t32(filtered_tapers(ws, nw, 0.9)).to(device)
    return (TC.tapered_rfft(t32(eeg).to(device), tapers),
            TC.tapered_rfft(t32(emg).to(device), tapers))


def test_package_imports_neither_jax_nor_mba_tpu():
    """In a fresh interpreter: the pytest process has JAX loaded already
    (tests/conftest.py), so only a subprocess can tell; the port's entry
    script ``torch_entry.py`` is held to it too.  matplotlib and
    sklearn are not loaded either: the port imports them only to draw and
    inside the MI fit, the clustering and the song features' K-means (the
    card machine has neither)."""
    names = _module_names()
    assert {"mba_tpu_torch.ops.cuda_msc", "mba_tpu_torch.ops.cuda_null",
            "mba_tpu_torch.ops.cuda_coeffs",
            "mba_tpu_torch.ops.rotation_coeffs",
            "mba_tpu_torch.ops.spectral", "mba_tpu_torch.ops.surrogate",
            "mba_tpu_torch.channel_layout",
            "mba_tpu_torch.utils.file_management",
            "mba_tpu_torch.pipeline.signal_features",
            "mba_tpu_torch.pipeline.data_integration",
            "mba_tpu_torch.pipeline.data_analysis",
            "mba_tpu_torch.pipeline.cbpa",
            "mba_tpu_torch.workflows.subject_feature_extraction_workflow",
            "mba_tpu_torch.ops.prng", "mba_tpu_torch.ops.cuda_prng",
            "mba_tpu_torch.ops.filters", "mba_tpu_torch.ops.wavelet",
            "mba_tpu_torch.ops.ic_classify", "mba_tpu_torch.ops.ica",
            "mba_tpu_torch.pipeline.preprocessing",
            "mba_tpu_torch.workflows.preprocessing_workflow",
            "mba_tpu_torch.convert",
            "mba_tpu_torch.models.fdr", "mba_tpu_torch.models.ols",
            "mba_tpu_torch.models.formula", "mba_tpu_torch.models.lme",
            "mba_tpu_torch.models.mediation",
            "mba_tpu_torch.pipeline.statistical_modelling",
            "mba_tpu_torch.ops.permutation",
            "mba_tpu_torch.pipeline.visualizations",
            "mba_tpu_torch.workflows.statistics_RQ_A_omnibus_testing_workflow",
            "mba_tpu_torch.workflows.statistics_RQ_B_omnibus_testing_workflow",
            "mba_tpu_torch.workflows."
            "statistics_RQ_A_mediation_analysis_workflow",
            "mba_tpu_torch.workflows.paths",
            "mba_tpu_torch.acquisition.sampling", "mba_tpu_torch.io.otb4",
            "mba_tpu_torch.workflows.otb4_import_workflow",
            "mba_tpu_torch.workflows.study_curation",
            "mba_tpu_torch.workflows.data_integration_workflow",
            "mba_tpu_torch.workflows.statistics_data_preparation_workflow",
            "mba_tpu_torch.workflows."
            "statistics_RQ_A_post_hoc_testing_workflow",
            "mba_tpu_torch.tools.synth_study",
            "mba_tpu_torch.pipeline.statistical_reporting",
            "mba_tpu_torch.workflows.statistics_report_workflow",
            "mba_tpu_torch.pipeline.heterogeneity_modelling",
            "mba_tpu_torch.workflows.descriptive_statistics_workflow",
            "mba_tpu_torch.workflows.time_alignment_validation_workflow",
            "mba_tpu_torch.pipeline.music_control",
            "mba_tpu_torch.workflows.music_feature_extraction_workflow",
            "mba_tpu_torch.parallel", "mba_tpu_torch.parallel.mesh",
            "mba_tpu_torch._dist",
            "mba_tpu_torch.parallel.cohort",
            "mba_tpu_torch.acquisition",
            "mba_tpu_torch.acquisition.experiment",
            "mba_tpu_torch.acquisition.views",
            "mba_tpu_torch.native", "mba_tpu_torch.native.build",
            "mba_tpu_torch.pipeline.sensor_calibration",
            "mba_tpu_torch.utils.str_conversion",
            "mba_tpu_torch.utils.function_decorators",
            "mba_tpu_torch.utils.multiprocessing_tools",
            "mba_tpu_torch.workflows.experiment_workflow",
            "mba_tpu_torch.workflows.serial_testing_workflow",
            "mba_tpu_torch.utils.transfer", "mba_tpu_torch.utils.profiling",
            "mba_tpu_torch.native.quantize",
            } <= set(names)
    # torch_entry.py, the port's entry script, beside the package
    code = (f"import importlib, sys\n"
            f"for name in {names + ['torch_entry']!r}:\n"
            f"    importlib.import_module(name)\n"
            f"bad = sorted(m for m in sys.modules if m.split('.')[0]\n"
            f"             in ('jax', 'jaxlib', 'mba_tpu', 'matplotlib',\n"
            f"                 'sklearn'))\n"
            f"assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_package_and_its_exports_load_no_pandas():
    """``import mba_tpu_torch`` and its re-exporting sub-packages stay
    cheap: no pandas, matplotlib, sklearn or JAX, and no kernel build."""
    code = ("import sys\n"
            "import mba_tpu_torch, mba_tpu_torch.ops, mba_tpu_torch.models\n"
            "import mba_tpu_torch.workflows, mba_tpu_torch.utils.transfer\n"
            "import mba_tpu_torch.utils.profiling\n"
            "from mba_tpu_torch import _build\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('pandas', 'matplotlib', 'sklearn', 'jax',\n"
            "              'mba_tpu'))\n"
            "assert not bad, bad\n"
            "assert _build.load_library.cache_info().currsize == 0\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("sub", ["ops", "models", "workflows"])
def test_package_exports_match_jax(sub):
    """Every name that ``mba_tpu.<sub>`` re-exports, the port's
    ``mba_tpu_torch.<sub>`` re-exports too, under the same name and of the
    same kind (function or class); ``channel_layout`` is a module of both
    top-level packages."""
    import inspect
    jax_mod = importlib.import_module(f"mba_tpu.{sub}")
    port_mod = importlib.import_module(f"mba_tpu_torch.{sub}")
    names = [n for n, v in vars(jax_mod).items()
             if not n.startswith("_") and not inspect.ismodule(v)]
    assert names
    for name in names:
        ref, got = getattr(jax_mod, name), getattr(port_mod, name)
        assert inspect.isclass(got) == inspect.isclass(ref), name
        assert callable(got), name
    import mba_tpu
    assert inspect.ismodule(mba_tpu.channel_layout)
    assert mba_tpu_torch.channel_layout.EEG_CHANNELS == \
        mba_tpu.channel_layout.EEG_CHANNELS
    from mba_tpu_torch.ops import coherence
    assert coherence.fisher_atanh is mba_tpu_torch.ops.fisher_atanh
    assert coherence.inverse_fisher_atanh is \
        mba_tpu_torch.ops.inverse_fisher_atanh


def test_plots_load_matplotlib_when_they_draw(tmp_path):
    """In a fresh interpreter: the omnibus forest mosaic draws (Agg) and
    saves a PNG, and only then is matplotlib loaded."""
    code = ("import sys, pandas as pd\n"
            "from mba_tpu_torch.pipeline import visualizations as V\n"
            "assert 'matplotlib' not in sys.modules\n"
            "df = pd.DataFrame({'Model_Type': ['LME'] * 2,\n"
            "                   'Dependent_Variable': ['DV'] * 2,\n"
            "                   'Parameter': ['Intercept', 'x'],\n"
            "                   'Coefficient': [1.0, 0.5], 'SE': [0.1, 0.1],\n"
            "                   'p_value_for_plot': [0.5, 0.01]})\n"
            f"V.draw_forest_mosaic(df, save_dir={str(tmp_path)!r})\n"
            "import matplotlib\n"
            "assert matplotlib.get_backend().lower() == 'agg'\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(list(tmp_path.glob("*Forest Mosaic.png"))) == 1


def test_importing_builds_nothing():
    for name in _module_names():
        importlib.import_module(name)
    assert _build.load_library.cache_info().currsize == 0


def test_build_command_targets_sm90a_without_fast_math(tmp_path):
    """One compile command per source, then one link command; sm_90a,
    no fast math and no flush-to-zero (B3 clamps denormal powers as the
    CPU does)."""
    srcs = _build.sources()
    assert {p.name for p in srcs} == {"msc_jackknife.cu", "null_tile.cu",
                                      "null_tile_tc.cu", "coeff_pairs.cu",
                                      "threefry.cu"}
    for src in srcs:
        cmd = _build.compile_command(tmp_path / "k.o", src, "nvcc")
        assert cmd[0] == "nvcc" and cmd[-1] == str(src)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert not any("fast_math" in c or "fast-math" in c or "ftz" in c
                       for c in cmd)
        for flag in ("-O3", "-c", "-std=c++17", "-fPIC"):
            assert flag in cmd
    objs = [tmp_path / "a.o", tmp_path / "b.o"]
    cmd = _build.link_command(tmp_path / "lib.so", objs, "nvcc")
    assert cmd[0] == "nvcc" and "-shared" in cmd
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert [str(p) for p in objs] == cmd[-2:]
    assert _build.library_path().parent == _build.BUILD_DIR
    assert _build.library_path().name.startswith("libmba_kernels_")


def test_null_tile_split_forms_match_the_source():
    """``chip_probe.py null-tile-split`` times edited copies of B2's 16-bit
    source: each edit's old text must occur in it exactly once, or the
    probe would time a form other than the one it names."""
    sys.path.insert(0, str(REPO))
    import chip_probe
    src = (_build.CSRC_DIR / "null_tile_tc.cu").read_text()
    assert chip_probe.NULL_TC_FORMS["as_is"] == []
    for form, edits in chip_probe.NULL_TC_FORMS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (form, old)


def test_coeff_split_forms_match_the_source():
    """``chip_probe.py coeff-split`` times edited copies of B3's source:
    each edit's old text must occur in it exactly once, or the probe would
    time a form other than the one it names."""
    sys.path.insert(0, str(REPO))
    import chip_probe
    src = (_build.CSRC_DIR / "coeff_pairs.cu").read_text()
    assert chip_probe.COEFF_FORMS["as_is"] == []
    for form, edits in chip_probe.COEFF_FORMS.items():
        for old, _ in edits:
            assert src.count(old) == 1, (form, old)


def test_coeff_split_reads_the_runtime_k_kernels_registers():
    """``chip_probe.py coeff-split`` reports, per form, the registers and
    spills ptxas gives ``coeff_pairs_rt_kernel`` and no other entry."""
    sys.path.insert(0, str(REPO))
    import chip_probe
    text = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119coeff_powers_kernelEPK6float2S2_PfS3_iiiii' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 32 registers, used 0 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_121coeff_pairs_rt_kernelEPK6float2S2_PKfS4_S4_"
        "PfS5_S5_NS_6RtGeomE' for 'sm_90a'",
        "    24 bytes stack frame, 4 bytes spill stores, 20 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 1 barriers",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_119coeff_pairs_kernelILi5ELb1EEEvPK6float2' "
        "for 'sm_90a'",
        "ptxas info    : Used 96 registers, used 1 barriers"])
    assert chip_probe._rt_ptxas(text) == {
        "spill_stores": 4, "spill_loads": 20, "registers": 128}
    assert chip_probe._rt_ptxas("") == {}


_FAKE_NVCC = """#!/bin/sh
# stands in for nvcc: writes its -o target, or fails on request
out=""; prev=""
for a in "$@"; do
  [ "$prev" = "-o" ] && out="$a"
  prev="$a"
done
case "$*" in *{fail}*) echo "error in {fail}" >&2; exit 2;; esac
echo "$*" > "$out"
"""


def _fake_build(tmp_path, monkeypatch, fail="never-matches"):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.replace("{fail}", fail))
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    return _build.build


def test_build_compiles_each_source_then_links(tmp_path, monkeypatch):
    out = _fake_build(tmp_path, monkeypatch)()
    assert out == _build.library_path() and out.exists()
    link = out.read_text().split()
    objs = [a for a in link if a.endswith(".o")]
    assert "-shared" in link and len(objs) == len(_build.sources())
    # the objects and the private library name are gone
    assert sorted(p.name for p in out.parent.iterdir()) == [out.name]
    assert _build.build() == out                 # built once


def test_build_failure_names_the_source(tmp_path, monkeypatch):
    with pytest.raises(RuntimeError, match="coeff_pairs.cu"):
        _fake_build(tmp_path, monkeypatch, fail="coeff_pairs.cu")()
    assert not list((tmp_path / "build").iterdir())


def test_cpu_tensors_take_the_plain_msc_epilogue():
    e, m = _spectra(0, 2, 128, 3, 4)
    before = cuda_msc.msc_jackknife.launches
    for emg_max in (True, False):
        got = cuda_msc.msc_jackknife(e, m, 2.776, emg_max=emg_max)
        ref = cuda_msc.msc_jackknife_plain(e, m, 2.776, emg_max=emg_max)
        for key in KEYS:
            torch.testing.assert_close(got[key], ref[key], rtol=0, atol=0)
    assert cuda_msc.msc_jackknife.launches == before


def test_cpu_tensors_take_the_plain_null_tile():
    J, nF, N, K = 2, 3, 100, 3
    coef, base, obs = null_toy(J, nF, N, K, seed=1)
    state = TN.null_state(t32(base), t32(coef), t32(obs))
    phi = TN.draw_phases(prng.prng_key(0), J, 13, K, nF, "cpu")
    G = cuda_null.null_features(TN.phase_features(phi))
    before = cuda_null.null_tile.launches
    ms, cnt = cuda_null.null_tile(G, state.coefT, state.base_flat,
                                  state.observed_flat, J)
    ms_ref, cnt_ref = cuda_null.null_tile_plain(
        G, state.coefT, state.base_flat, state.observed_flat, J)
    assert cuda_null.null_tile.launches == before
    assert cnt.dtype == torch.int32 and tuple(ms.shape) == (13,)
    torch.testing.assert_close(ms, ms_ref, rtol=0, atol=0)
    torch.testing.assert_close(cnt, cnt_ref, rtol=0, atol=0)


def _bad_msc_inputs():
    e, m = _spectra(1, 1, 64, 2, 2)
    return [
        (e.to(torch.complex128), m, TypeError),
        (e[..., :1], m.transpose(2, 3), ValueError),   # not contiguous
        (e[:, :, :5].contiguous(), m, ValueError),      # (W, K, F) differ
        (e[0], m[0], ValueError),                       # not 4-D
        (e.to("meta"), m.to("meta"), ValueError),       # no CPU, no CUDA
    ]


@pytest.mark.parametrize("case", range(5))
def test_msc_wrapper_refuses_bad_input(case):
    e, m, exc = _bad_msc_inputs()[case]
    with pytest.raises(exc):
        cuda_msc.msc_jackknife(e, m, 2.0)


def _bad_null_inputs():
    G = torch.zeros((3, 12, 13))                        # (nF, JP, S)
    C = torch.zeros((3, 12, 100))
    b = torch.zeros((3, 100))
    return [
        (G.double(), C, b, b, TypeError),
        (G, C.transpose(1, 2).contiguous().transpose(1, 2), b, b,
         ValueError),                                   # not contiguous
        (G, C[:, :11].contiguous(), b, b, ValueError),  # J·P differs
        (G, C, b[:, :99].contiguous(), b, ValueError),  # base shape
        (G.to("meta"), C.to("meta"), b.to("meta"), b.to("meta"),
         ValueError),                                   # no CPU, no CUDA
    ]


@pytest.mark.parametrize("case", range(5))
def test_null_wrapper_refuses_bad_input(case):
    G, C, b, o, exc = _bad_null_inputs()[case]
    with pytest.raises(exc):
        cuda_null.null_tile(G, C, b, o, 2)


# ---- on the card --------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _np(d):
    return {k: v.cpu().numpy() for k, v in d.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("ws,nw,nE,nM", [(128, 2, 5, 3), (256, 3, 8, 6),
                                          (130, 3, 33, 7)])
def test_msc_kernel_matches_plain_on_card(cuda, ws, nw, nE, nM):
    """Both EMG modes, K = 3 and 5, F = 65/129/66 (ragged frequency
    blocks).  Coherence within 5e-5 (tests/test_ops_coherence.py:217);
    CIs within ``ci_tolerance``, which adds the float32 rounding that
    Fisher z amplifies where a jackknife replicate nears 1.  In the
    EMG-max mode the CIs are compared where the two argmax picks agree,
    which is every cell but near-ties."""
    e, m = _spectra(2, 3, ws, nE, nM, device=cuda, nw=nw)
    before = cuda_msc.msc_jackknife.launches
    kf = _np(cuda_msc.msc_jackknife(e, m, 2.5, emg_max=False))
    km = _np(cuda_msc.msc_jackknife(e, m, 2.5, emg_max=True))
    torch.cuda.synchronize()
    assert cuda_msc.msc_jackknife.launches == before + 2
    pf = _np(cuda_msc.msc_jackknife_plain(e, m, 2.5, emg_max=False))
    pm = _np(cuda_msc.msc_jackknife_plain(e, m, 2.5, emg_max=True))
    tol = cuda_msc.ci_tolerance(cuda_msc.loo_coherence_max(e, m).cpu()
                                .numpy())
    for key in KEYS:
        assert np.isfinite(kf[key]).all()
    np.testing.assert_allclose(kf["coherence"], pf["coherence"], atol=5e-5)
    for key in KEYS[1:]:
        assert (np.abs(kf[key] - pf[key]) <= tol).all(), key
    np.testing.assert_array_equal(km["coherence"], kf["coherence"].max(-1))
    np.testing.assert_allclose(km["coherence"], pm["coherence"], atol=5e-5)
    p_idx = np.argmax(pf["coherence"], -1)
    k_idx = np.argmin(np.abs(kf["coherence"] - km["coherence"][..., None]), -1)
    same = k_idx == p_idx
    assert same.mean() >= 0.99
    tol_max = np.take_along_axis(tol, p_idx[..., None], -1)[..., 0]
    for key in KEYS[1:]:
        assert (np.abs(km[key] - pm[key])[same] <= tol_max[same]).all(), key


@pytest.mark.cuda
@pytest.mark.parametrize("transfer", list(MSC_TRANSFERS))
@pytest.mark.parametrize("options", list(MSC_OPTIONS))
@pytest.mark.parametrize("mask", list(MSC_MASKS))
def test_cmc_results_land_in_place_on_card(cuda, monkeypatch, mask, options,
                                           transfer):
    """On the card each run of active windows downloads straight into its
    rows of the full grid (float32), or its 16-bit or dequantized rows
    are placed on the host: the same bits, bytes and zero rows as a whole
    download then a fancy-index scatter, one copy a result and run."""
    check_msc_assembly(monkeypatch, cuda, mask, options, transfer)


@pytest.mark.cuda
@pytest.mark.parametrize("nw,nE,nM", [(5, 8, 6), (5, 33, 7), (8.5, 8, 6),
                                      (9, 8, 6), (11, 33, 7), (13.5, 8, 6),
                                      (9, 3, 5)])
def test_msc_kernel_at_many_tapers_on_card(cuda, nw, nE, nM):
    """K = 9 and 16 (compile-time instances), 17, 21 and 25 (the runtime-K
    instances of buckets 20, 24 and 32; K = 17 also at an odd narrow
    montage, 3×5) in both EMG modes against the plain version, at the
    tolerances of ``test_msc_kernel_matches_plain_on_card``; the EMG-max
    value is the full grid's max."""
    e, m = _spectra(4, 3, 256, nE, nM, device=cuda, nw=nw)
    assert e.shape[1] == {5: 9, 8.5: 16, 9: 17, 11: 21, 13.5: 25}[nw]
    before = cuda_msc.msc_jackknife.launches
    kf = _np(cuda_msc.msc_jackknife(e, m, 2.1, emg_max=False))
    km = _np(cuda_msc.msc_jackknife(e, m, 2.1, emg_max=True))
    torch.cuda.synchronize()
    assert cuda_msc.msc_jackknife.launches == before + 2
    pf = _np(cuda_msc.msc_jackknife_plain(e, m, 2.1, emg_max=False))
    tol = cuda_msc.ci_tolerance(cuda_msc.loo_coherence_max(e, m).cpu()
                                .numpy())
    np.testing.assert_allclose(kf["coherence"], pf["coherence"], atol=5e-5)
    for key in KEYS[1:]:
        assert (np.abs(kf[key] - pf[key]) <= tol).all(), key
    np.testing.assert_array_equal(km["coherence"], kf["coherence"].max(-1))
    idx, at_pick = _pick_and_take(kf, km)
    for key in KEYS:
        np.testing.assert_array_equal(km[key], at_pick[key], err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [3, 8.5])
@pytest.mark.parametrize("nE,nM", [(64, 64), (11, 64), (3, 5)])
def test_msc_runtime_k_path_equals_compile_time_on_card(cuda, nw, nE, nM):
    """K = 5 and 16: the runtime-K path (``msc_jackknife_runtime_k``, the
    instances that serve K > 16) gives the compile-time instance's floats
    bit for bit in both EMG modes, at 64×64, at the task CMC's 11×64 and
    at 3×5 (two lanes a cell in the EMG-max scan), NaN where NaN."""
    e, m = _spectra(5, 2, 256, nE, nM, device=cuda, nw=nw)
    assert e.shape[1] == {3: 5, 8.5: 16}[nw]
    before = cuda_msc.msc_jackknife.launches
    for emg_max in (True, False):
        a = cuda_msc.msc_jackknife(e, m, 2.5, emg_max=emg_max)
        b = cuda_msc.msc_jackknife_runtime_k(e, m, 2.5, emg_max=emg_max)
        for key in KEYS:
            assert torch.equal(a[key].isnan(), b[key].isnan()), key
            assert torch.equal(a[key].nan_to_num(), b[key].nan_to_num()), key
    assert cuda_msc.msc_jackknife.launches == before + 4


@pytest.mark.cuda
def test_msc_kernel_carries_nan_of_a_coherent_pair(cuda):
    """EMG channel 1 = EEG channel 2: every leave-one-out ratio is
    exactly 1, the float32 Fisher clip lets it through to +inf and the z
    variance to NaN, which jnp.maximum/minimum carry into both CIs (the
    XLA kernel, and the plain version on the CPU that
    tests/test_torch_coherence.py ties to it).  The kernel keeps the
    XLA formula's products unfused, so it must give that NaN too, not
    drop it as fmaxf/fminf would.  (The plain version on the card need
    not: PyTorch's CUDA complex product may fuse a multiply-add.)"""
    e, m = _spectra(3, 2, 256, 6, 3)
    m[..., 1] = e[..., 2]
    kf = _np(cuda_msc.msc_jackknife(e.to(cuda), m.to(cuda), 2.776,
                                    emg_max=False))
    pf = _np(cuda_msc.msc_jackknife_plain(e, m, 2.776, emg_max=False))
    pair = np.zeros(kf["coherence"].shape, bool)
    pair[..., 2, 1] = True
    np.testing.assert_allclose(kf["coherence"], pf["coherence"], atol=5e-5)
    tol = cuda_msc.ci_tolerance(cuda_msc.loo_coherence_max(e, m).numpy())
    for key in KEYS[1:]:
        a, b = kf[key], pf[key]
        assert not np.isnan(a[~pair]).any()
        assert np.isnan(b[pair]).mean() > 0.9
        assert np.isnan(a[pair]).all(), np.isnan(a[pair]).mean()
        assert (np.abs(a - b)[~pair] <= tol[~pair]).all()


@pytest.mark.cuda
def test_msc_emg_max_carries_nan_of_a_coherent_pair(cuda):
    """The coherent-pair test in the EMG-max mode: EEG channel 2's pick
    is EMG channel 1 (coherence 1, the largest), whose CIs are NaN; the
    CIs are formed after the scan, for the pick alone, and keep that
    NaN.  Every other EEG channel's CIs are finite and equal the full
    grid's at its pick."""
    e, m = _spectra(3, 2, 256, 6, 3)
    m[..., 1] = e[..., 2]
    kf = _np(cuda_msc.msc_jackknife(e.to(cuda), m.to(cuda), 2.776,
                                    emg_max=False))
    km = _np(cuda_msc.msc_jackknife(e.to(cuda), m.to(cuda), 2.776,
                                    emg_max=True))
    idx, at_pick = _pick_and_take(kf, km)
    assert (idx[..., 2] == 1).mean() > 0.9
    pair = np.zeros(km["coherence"].shape, bool)
    pair[..., 2] = idx[..., 2] == 1
    for key in KEYS[1:]:
        assert np.isnan(km[key][pair]).all(), key
        assert not np.isnan(km[key][~pair]).any(), key
        np.testing.assert_array_equal(km[key], at_pick[key], err_msg=key)
    np.testing.assert_array_equal(km["coherence"], at_pick["coherence"])


def _check_null_kernel(cuda, J, K, S, N, nF):
    """max_stat within 1e-5; counts equal except where float32
    accumulation order moves a stat across obs (at most 1e-4 of cells,
    by one); no cell counts more than the S real surrogates."""
    coef, base, obs = null_toy(J, nF, N, K, seed=S)
    state = TN.null_state(t32(base).to(cuda), t32(coef).to(cuda),
                          t32(obs).to(cuda))
    G = cuda_null.null_features(TN.phase_features(
        TN.draw_phases(prng.prng_key(S), J, S, K, nF, cuda)))
    before = cuda_null.null_tile.launches
    ms, cnt = cuda_null.null_tile(G, state.coefT, state.base_flat,
                                  state.observed_flat, J)
    torch.cuda.synchronize()
    assert cuda_null.null_tile.launches == before + 1
    ms_ref, cnt_ref = cuda_null.null_tile_plain(
        G, state.coefT, state.base_flat, state.observed_flat, J)
    np.testing.assert_allclose(ms.cpu().numpy(), ms_ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    diff = (cnt - cnt_ref).abs().cpu().numpy()
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    assert int(cnt.max()) <= S


def _check_null_kernel_16bit(cuda, dtype, J, K, S, N, nan_cell=None):
    """B2's 16-bit instance (the tensor cores) against its plain version
    (``bmm`` of the rounded operands, widened), 4 frequencies.  Maxima
    within rtol 1e-5 (NaN where the plain version's ``amax`` gives NaN);
    counts equal but in cells whose statistic lies within 1e-5 of the
    observed one, where the tensor cores' order of the float32 sums may
    move it across; no count above S.  ``nan_cell`` (f, n) puts a NaN in
    one coefficient: that cell's statistic is NaN for every surrogate, so
    every max is NaN and the cell never counts."""
    nF = 4
    coef, base, obs = null_toy(J, nF, N, K, seed=S + N)
    if nan_cell is not None:
        coef[J // 2, nan_cell[0], nan_cell[1], 1] = np.nan
    state = TN.null_state(t32(base).to(cuda), t32(coef).to(cuda),
                          t32(obs).to(cuda), dtype)
    phi = TN.draw_phases(prng.prng_key(S), J, S, K, nF, cuda)
    G = cuda_null.null_features(TN.phase_features(phi), dtype)
    assert G.dtype == dtype and G.shape[2] % 8 == 0
    assert state.coefT.shape[2] % 8 == 0 and G.shape[1] == J * K * (K - 1)
    before = cuda_null.null_tile.launches
    ms, cnt = cuda_null.null_tile(G, state.coefT, state.base_flat,
                                  state.observed_flat, J, S)
    torch.cuda.synchronize()
    assert cuda_null.null_tile.launches == before + 1
    ms_ref, cnt_ref = cuda_null.null_tile_plain(
        G, state.coefT, state.base_flat, state.observed_flat, J, S)
    assert ms.shape == (S,) and cnt.shape == (nF, N)
    np.testing.assert_allclose(ms.cpu().numpy(), ms_ref.cpu().numpy(),
                               rtol=1e-5)
    assert bool(torch.isnan(ms).all()) == (nan_cell is not None)
    rows = G[..., :S].transpose(1, 2).float()
    stat = state.base_flat[:, None] + torch.bmm(
        rows, state.coefT[..., :N].float()) / J
    ties = ((stat - state.observed_flat[:, None]).abs() <= 1e-5).any(1)
    differ = (cnt != cnt_ref)
    assert not bool((differ & ~ties).any())
    assert int(cnt.max()) <= S
    if nan_cell is not None:
        assert int(cnt[nan_cell]) == int(cnt_ref[nan_cell]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("J,K,S,N", [
    (2, 3, 13, 100), (3, 3, 64, 512), (12, 5, 65, 4096 + 8),
    (125, 2, 129, 4096 + 7), (12, 5, 500, 4096), (3, 5, 500, 512),
    (30, 5, 129, 100)])
def test_null_kernel_reduced_precision_on_card(cuda, dtype, J, K, S, N):
    """The tensor-core tile's edges: S = 13, 64, 65, 129 and 500 against
    the 128-surrogate tile and its two 64-row warpgroups (pad rows never
    count); J·P = 12, 18, 240, 250 and 60 against the 64-deep slice, and
    600, past the four slices the cell tile's coefficients stay for (both
    rings stream); N = 100 (no 16-byte rows: coefT's cell axis padded to
    104), 512, 4096 + 8 and 4096 + 7 against the 256-cell tile.  The
    tolerances of :func:`_check_null_kernel_16bit`."""
    _check_null_kernel_16bit(cuda, dtype, J, K, S, N)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_null_kernel_reduced_precision_carries_nan_on_card(cuda, dtype):
    """A NaN coefficient: every max NaN, as the plain version's ``amax``
    gives it, and the NaN cell never counts."""
    _check_null_kernel_16bit(cuda, dtype, 3, 5, 129, 4096 + 7,
                             nan_cell=(2, 4100))


@pytest.mark.cuda
@pytest.mark.parametrize("J,K,S,N", [(2, 3, 13, 100), (3, 3, 70, 512),
                                     (2, 5, 129, 4096 + 7)])
def test_null_kernel_matches_plain_on_card(cuda, J, K, S, N):
    """Ragged S (padded surrogate rows must not count), ragged J·P
    (12, 18, 40 against the 16-deep slice) and ragged N, 4 frequencies."""
    _check_null_kernel(cuda, J, K, S, N, nF=4)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [127, 128, 129])
@pytest.mark.parametrize("J,K", [(2, 3), (3, 3), (2, 5), (12, 5)])
def test_null_kernel_at_the_tile_edges_on_card(cuda, J, K, S):
    """The 128 × 128 block tile's edges: S one short of, equal to and one
    past a surrogate tile; N = 4096 + 7, three cells into a last cell
    tile and not a multiple of 4 (the 4-byte copy path); J·P = 12, 18,
    40 and 240 against the 16-deep slice; one frequency."""
    _check_null_kernel(cuda, J, K, S, 4096 + 7, nF=1)


@pytest.mark.cuda
def test_null_kernel_16_byte_copies_on_card(cuda):
    """S and N multiples of 4: both operands take the 16-byte copies, as
    on the main path (S = 500, N = 4096), here with a ragged S tile."""
    _check_null_kernel(cuda, 12, 5, 500, 4096, nF=8)


def _random_spectra(seed, W, K, F, E, M, device):
    """Random complex64 spectra (W, K, F, E) and (W, K, F, M) with a
    common part, so each EEG channel has a clear EMG favourite."""
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    common = cplx(W, K, F, 1)
    e = common + cplx(W, K, F, E)
    m = rng.uniform(0.2, 2.0, M) * common + cplx(W, K, F, M)
    return (torch.from_numpy(e.astype(np.complex64)).to(device),
            torch.from_numpy(m.astype(np.complex64)).to(device))


def _pick_and_take(kf, km):
    """The full grid's first argmax over EMG, and its values there."""
    idx = np.argmax(kf["coherence"], axis=-1)[..., None]
    return idx[..., 0], {k: np.take_along_axis(kf[k], idx, -1)[..., 0]
                         for k in KEYS}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 5, 8])
@pytest.mark.parametrize("E,M", [(64, 64), (11, 64), (1, 64), (3, 64)])
def test_msc_emg_max_is_the_full_grid_at_its_pick_on_card(cuda, K, E, M):
    """The EMG-max mode computes the CIs of its pick only, through the
    same code as the full grid: coherence and both CIs bitwise equal to
    the full grid's at the first argmax, at the main path's 64×64
    montage, the task CMC's 11×64, and E = 1 and 3 (the blocks' widest
    frequency spans).  F = 129 leaves a ragged frequency block."""
    e, m = _random_spectra(K * 100 + E, 2, K, 129, E, M, cuda)
    kf = _np(cuda_msc.msc_jackknife(e, m, 2.5, emg_max=False))
    km = _np(cuda_msc.msc_jackknife(e, m, 2.5, emg_max=True))
    _, at_pick = _pick_and_take(kf, km)
    for key in KEYS:
        assert km[key].shape == (2, 129, E)
        np.testing.assert_array_equal(km[key], at_pick[key], err_msg=key)
    assert not np.isnan(km["ci_lower"]).any()


@pytest.mark.cuda
def test_msc_emg_max_tie_takes_the_first_channel_on_card(cuda):
    """EMG channel 5 duplicates channel 2, which is near-coherent with
    EEG channel 0: the two coherence values are the same floats, so the
    scan's strict '>' keeps channel 2, the first of the maxima, as
    jnp.argmax does, and the result is the full grid's at channel 2.
    (Equal inputs give equal CIs, so the outputs cannot tell channel 2
    from 5: the test holds them to the first index's values.)"""
    e, m = _random_spectra(11, 3, 5, 65, 7, 8, "cpu")
    m[..., 2] = 3.0 * e[..., 0] + 0.1 * m[..., 2]
    m[..., 5] = m[..., 2]
    kf = _np(cuda_msc.msc_jackknife(e.to(cuda), m.to(cuda), 2.5,
                                    emg_max=False))
    km = _np(cuda_msc.msc_jackknife(e.to(cuda), m.to(cuda), 2.5,
                                    emg_max=True))
    np.testing.assert_array_equal(kf["coherence"][..., 2],
                                  kf["coherence"][..., 5])
    idx, at_pick = _pick_and_take(kf, km)
    tied = idx == 2
    assert tied[..., 0].all()               # EEG 0's maximum is the tie
    for key in KEYS:
        np.testing.assert_array_equal(km[key], at_pick[key], err_msg=key)
        np.testing.assert_array_equal(km[key][tied], kf[key][..., 2][tied])


@pytest.mark.cuda
def test_multitaper_msc_on_card_runs_the_kernel(cuda):
    """The entry point on the card against the same call on the CPU
    (plain versions), CIs within ``ci_tolerance`` of the replicates."""
    eeg, emg = coupled_signals(seconds=8, n_eeg=4, n_emg=5)
    before = cuda_msc.msc_jackknife.launches
    got = TC.multitaper_msc(eeg, emg, 256, device=cuda)
    assert cuda_msc.msc_jackknife.launches > before
    ref = TC.multitaper_msc(eeg, emg, 256, device="cpu")
    assert got["metadata"] == ref["metadata"]
    np.testing.assert_allclose(got["coherence_raw"], ref["coherence_raw"],
                               atol=5e-5)
    starts, _ = window_grid(len(eeg), 256, 128, 256.0)
    tapers = t32(filtered_tapers(256, 3, 0.9))
    e, m = (TC.tapered_rfft(frame_signal(t32(x), starts, 256), tapers)
            for x in (eeg, emg))
    tol = cuda_msc.ci_tolerance(cuda_msc.loo_coherence_max(e, m).numpy())
    for key in ("coherence_ci_lower", "coherence_ci_upper"):
        assert got[key].dtype == np.float32
        assert (np.abs(got[key] - ref[key]) <= tol).all(), key


@pytest.mark.cuda
def test_rotation_null_on_card_runs_the_kernel(cuda):
    subj = [cohort_subject(20 + j, n_sec=12.0, couple=2.0) for j in range(2)]
    eeg = np.stack([s[0] for s in subj])
    emg = np.stack([s[1] for s in subj])
    kw = dict(sampling_freq=256.0, band=(8.0, 60.0), n_surrogates=600,
              surrogate_chunk=256)
    before = cuda_null.null_tile.launches
    got = TN.cohort_msc_rotation_null(eeg, emg, device=cuda, **kw)
    assert cuda_null.null_tile.launches == before + 3
    ref = TN.cohort_msc_rotation_null(eeg, emg, **kw, device="cpu")
    sc = float(np.abs(ref["observed"]).max())
    np.testing.assert_allclose(got["observed"], ref["observed"],
                               rtol=2e-4, atol=2e-5 * sc)
    assert got["max_stat"].shape == (600,)
    assert np.isfinite(got["max_stat"]).all()
    assert got["metadata"]["n_surrogates_drawn"] == 768


def _coeff_spectra(seed, wc, K, nF, nE, nM, device):
    """Random complex64 band spectra and weights with zero-weight
    windows, on ``device``."""
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return torch.from_numpy((rng.standard_normal(shape)
                                 + 1j * rng.standard_normal(shape))
                                .astype(np.complex64)).to(device)
    w = rng.uniform(0.5, 2.0, wc).astype(np.float32)
    w[::3] = 0.0
    return (cplx(wc, K, nF, nE), cplx(wc, K, nF, nM),
            torch.from_numpy(w).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("K,wc,nF,nE,nM", [
    (3, 7, 5, 3, 5),          # small M: 8 EMG lanes, 32 EEG rows a block
    (5, 32, 17, 64, 64),      # the main path's tile shape
    (5, 9, 3, 5, 70),         # M > 64: two EMG tiles, the second ragged
    (8, 6, 4, 11, 37),        # K = 8: 57 sums a cell
    (5, 1, 4, 64, 64),        # one window: one group, mostly empty
    (5, 7, 3, 11, 37),        # wc below the window group; E and M ragged
    (5, 33, 5, 5, 70),        # a group and one window; M over one tile
    (2, 9, 6, 11, 37),        # K = 2: one pair
    (8, 33, 3, 5, 70),        # K = 8 at the ragged edges
    (4, 7, 4, 1, 1),          # one cell a frequency
    (5, 32, 2, 7, 9),         # odd E and M: 8-byte copies
    (6, 10, 3, 9, 20),        # K = 6
    (7, 5, 3, 6, 12),         # K = 7, the runtime (narrow) tile
    (8, 9, 2, 3, 10),         # K = 8, the runtime (narrow) tile
])
def test_coeff_kernel_matches_plain_on_card(cuda, K, wc, nF, nE, nM):
    """Window sums over the chunk's weight sum within rtol 2e-5 / atol
    2e-6 (``cuda_coeffs`` module docstring: each window's terms are at
    most its weight in size; FMA contraction and the order of the sums
    differ).  Every third window has weight 0."""
    e, m, w = _coeff_spectra(K + wc, wc, K, nF, nE, nM, cuda)
    before = cuda_coeffs.coeff_pairs.launches
    got = cuda_coeffs.coeff_pairs(e, m, w)
    torch.cuda.synchronize()
    assert cuda_coeffs.coeff_pairs.launches == before + 1
    ref = cuda_coeffs.coeff_pairs_plain(e, m, w)
    wsum = float(w.sum())
    for a, b in zip(got, ref):
        assert tuple(a.shape) == tuple(b.shape)
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.cpu().numpy() / wsum,
                                   b.cpu().numpy() / wsum,
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("K,wc,nF,nE,nM,accumulate", [
    (9, 32, 5, 64, 64, False),    # nw = 5: the wide compile-time tile
    (9, 7, 3, 11, 37, True),      # ... the narrow one, accumulating
    (12, 9, 3, 8, 40, False),
    (16, 33, 2, 6, 64, True),     # the largest compile-time instance
    (17, 10, 3, 5, 37, False),    # the runtime-K instance
    (21, 9, 2, 3, 70, True),
    (17, 32, 2, 64, 64, True),    # the main path's tile, accumulating
    (25, 9, 2, 5, 37, False),     # 7 taper blocks: 28 tiles, two passes
    (25, 33, 3, 3, 5, True),      # an odd narrow montage: 16 EEG a unit
    (40, 9, 2, 3, 10, True),      # 55 tiles, four passes
])
def test_coeff_kernel_at_many_tapers_on_card(cuda, K, wc, nF, nE, nM,
                                             accumulate):
    """K above 8 against the plain version at the tolerance of
    ``test_coeff_kernel_matches_plain_on_card``, plain and ``out=``."""
    e, m, w = _coeff_spectra(K + wc, wc, K, nF, nE, nM, cuda)
    ref = cuda_coeffs.coeff_pairs_plain(e, m, w)
    out = None
    if accumulate:
        out = tuple(torch.full_like(x, 0.25) for x in ref)
        ref = tuple(x + 0.25 for x in ref)
    before = cuda_coeffs.coeff_pairs.launches
    got = cuda_coeffs.coeff_pairs(e, m, w, out=out)
    torch.cuda.synchronize()
    assert cuda_coeffs.coeff_pairs.launches == before + 1
    wsum = float(w.sum())
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.cpu().numpy() / wsum,
                                   b.cpu().numpy() / wsum,
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("K,wc,nF,nE,nM,accumulate", [
    (2, 5, 3, 4, 4, False),       # one tile: a one-warp block
    (5, 9, 3, 5, 70, True),
    (12, 9, 3, 8, 40, True),
    (16, 33, 2, 6, 64, False),
    (17, 0, 2, 3, 5, True),       # no window: out + zero sums
])
def test_coeff_runtime_k_instance_matches_plain_on_card(cuda, K, wc, nF, nE,
                                                        nM, accumulate):
    """The runtime-K instance forced at any K (``coeff_pairs_runtime_k``,
    as ``chip_probe.py coeff-dispatch`` times it beside the compile-time
    instances) against the plain version at the tolerance of
    ``test_coeff_kernel_matches_plain_on_card``, plain and ``out=``."""
    e, m, w = _coeff_spectra(K + wc, wc, K, nF, nE, nM, cuda)
    ref = cuda_coeffs.coeff_pairs_plain(e, m, w)
    out = None
    if accumulate:
        out = tuple(torch.full_like(x, 0.25) for x in ref)
        ref = tuple(x + 0.25 for x in ref)
    before = cuda_coeffs.coeff_pairs.launches
    got = cuda_coeffs.coeff_pairs_runtime_k(e, m, w, out=out)
    torch.cuda.synchronize()
    assert cuda_coeffs.coeff_pairs.launches == before + 1
    wsum = max(float(w.sum()), 1.0)
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.cpu().numpy() / wsum,
                                   b.cpu().numpy() / wsum,
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("K,nE,nM", [(5, 64, 64), (8, 11, 37), (3, 5, 70)])
def test_coeff_kernel_accumulates_two_chunks_on_card(cuda, K, nE, nM):
    """``out=`` adds each chunk's sums in the kernel: two chunks against
    the plain sums of each added in turn, at the tolerance above over the
    two chunks' weight sum; ``out`` comes back itself."""
    e, m, w = _coeff_spectra(40 + K, 45, K, 4, nE, nM, cuda)
    chunks = [(e[a:b].contiguous(), m[a:b].contiguous(), w[a:b].contiguous())
              for a, b in ((0, 32), (32, 45))]
    ref = cuda_coeffs.coeff_pairs_plain(*chunks[0])
    cuda_coeffs.coeff_pairs_plain(*chunks[1], out=ref)
    before = cuda_coeffs.coeff_pairs.launches
    out = cuda_coeffs.coeff_pairs(*chunks[0])
    got = cuda_coeffs.coeff_pairs(*chunks[1], out=out)
    torch.cuda.synchronize()
    assert got is out
    assert cuda_coeffs.coeff_pairs.launches == before + 2
    wsum = float(w.sum())
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.cpu().numpy() / wsum,
                                   b.cpu().numpy() / wsum,
                                   rtol=2e-5, atol=2e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [3, 17])
def test_coeff_kernel_zero_weight_and_nan(cuda, K):
    """A zero-weight window adds exact zeros; a NaN spectrum in one makes
    that cell's sums NaN, as the plain version (no fmaxf clamp); K = 3
    (a compile-time instance) and 17 (the runtime-K one)."""
    e, m, w = _coeff_spectra(1, 4, K, 6, 2, 3, "cpu")
    w[:] = torch.tensor([1.0, 0.0, 2.0, 0.5])
    e[1, 0, 4, 1] = complex(float("nan"), 0.0)
    got = [x.cpu() for x in cuda_coeffs.coeff_pairs(
        e.to(cuda), m.to(cuda), w.to(cuda))]
    ref = cuda_coeffs.coeff_pairs_plain(e, m, w)
    for a, b in zip(got, ref):
        nan = torch.isnan(b)
        assert torch.equal(torch.isnan(a), nan) and nan.any()
        np.testing.assert_allclose(a[~nan].numpy(), b[~nan].numpy(),
                                   rtol=2e-5, atol=2e-6 * 3.5)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(coeff_engine="pallas"),
                                dict(coeff_engine="xla"),
                                dict(rotation_mode="per_window")])
def test_rotation_engines_on_card_match_cpu(cuda, kw):
    subj = [cohort_subject(20 + j, n_sec=12.0, couple=2.0) for j in range(2)]
    eeg = np.stack([s[0] for s in subj])
    emg = np.stack([s[1] for s in subj])
    args = dict(sampling_freq=256.0, band=(8.0, 60.0), n_surrogates=600,
                surrogate_chunk=256, window_chunk=4, **kw)
    before = cuda_coeffs.coeff_pairs.launches
    got = TN.cohort_msc_rotation_null(eeg, emg, device=cuda, **args)
    n_launched = cuda_coeffs.coeff_pairs.launches - before
    assert n_launched == (6 if kw.get("coeff_engine") == "pallas" else 0)
    ref = TN.cohort_msc_rotation_null(eeg, emg, **args, device="cpu")
    np.testing.assert_allclose(got["observed"], ref["observed"],
                               rtol=2e-5, atol=2e-6)
    assert got["max_stat"].shape == (600,)
    assert np.isfinite(got["max_stat"]).all()
    # the same seed draws the same phases on both devices
    np.testing.assert_allclose(got["max_stat"], ref["max_stat"], rtol=1e-5,
                               atol=1e-5)


# ---- the threefry draw on the card ----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape,bounds", [
    ("uniform", (12, 500, 5, 175), (0.0, 2 * np.pi)),   # the null's draw
    ("uniform", (3, 7, 13), (-3.5, 7.25)),
    ("bits", (1001,), (0.0, 1.0)),
    ("pairs", (1000,), (0.0, 1.0))])                     # split(key, 1000)
def test_threefry_kernel_equals_plain_on_card(cuda, kind, shape, bounds):
    """Bit for bit: the kernel's integer rounds are exact and its one
    fused multiply-add is the plain version's single rounding."""
    key = prng.split(prng.prng_key(9))[1]
    before = cuda_prng.threefry_draw.launches
    got = cuda_prng.threefry_draw(key, shape, kind, cuda, *bounds)
    torch.cuda.synchronize()
    assert cuda_prng.threefry_draw.launches == before + 1
    assert got.device.type == "cuda"
    ref = cuda_prng.threefry_draw(key, shape, kind, "cpu", *bounds)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("n_keys,shape", [(8, (2, 1025)), (3, (7,)),
                                          (1, (5, 175))])
def test_threefry_many_keys_equal_plain_on_card(cuda, n_keys, shape):
    """One launch for many keys (the full-FFT null's per-surrogate
    draws), bit for bit the plain version's key by key."""
    keys = prng.split(prng.prng_key(11), n_keys)
    before = cuda_prng.threefry_draw.launches
    got = cuda_prng.uniform_keys(keys, shape, 0.0, 2 * np.pi, cuda)
    torch.cuda.synchronize()
    assert cuda_prng.threefry_draw.launches == before + 1
    ref = cuda_prng.uniform_keys(keys, shape, 0.0, 2 * np.pi, "cpu")
    assert got.shape == ref.shape and torch.equal(got.cpu(), ref)


# ---- the feature-extraction stage and the phase null on the card ----------

@pytest.mark.cuda
@pytest.mark.parametrize("log_scale", [False, True])
def test_spectral_estimators_on_card_match_cpu(cuda, log_scale):
    """PSD rtol 1e-4 with atol 1e-6·max (atol 1e-4 on log10), Welch rtol
    1e-4, amplitude spectrum 1e-6 of its peak, resampling 1e-6."""
    x, _ = coupled_signals(seconds=8, n_eeg=8, n_emg=1)
    kw = dict(window_length_sec=0.5, axis=0, apply_log_scale=log_scale)
    dev, _, _ = TS.multitaper_psd(x, 256.0, device=cuda, device_output=True,
                                  **kw)
    assert dev.device.type == "cuda"
    ref = TS.multitaper_psd(x, 256.0, **kw, device="cpu")[0]
    if log_scale:
        np.testing.assert_allclose(dev.cpu().numpy(), ref, rtol=0, atol=1e-4)
    else:
        np.testing.assert_allclose(dev.cpu().numpy(), ref, rtol=1e-4,
                                   atol=1e-6 * np.abs(ref).max())
    np.testing.assert_allclose(TS.welch_psd(x, 256.0, 512, device=cuda)[1],
                               TS.welch_psd(x, 256.0, 512, device="cpu")[1],
                               rtol=1e-4)
    a = TS.amplitude_spectrum(x, 256.0, device=cuda)[0]
    b = TS.amplitude_spectrum(x, 256.0, device="cpu")[0]
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())
    r = resample_linear(t32(x).to(cuda), 256.0, 200.0).cpu().numpy()
    np.testing.assert_allclose(r, resample_linear(t32(x), 256.0,
                                                  200.0).numpy(),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_band_aggregates_on_card_match_host(cuda):
    """rtol 1e-6 / atol 1e-7, NaNs equal (an all-NaN window, NaN bins)."""
    x, _ = coupled_signals(seconds=8, n_eeg=8, n_emg=1)
    spec, _, freqs = TS.multitaper_psd(x, 256.0, window_length_sec=0.5,
                                       axis=0, device=cuda,
                                       device_output=True)
    spec[3] = float("nan")
    spec[5, 10:20, 2] = float("nan")
    got, names, _ = TF.band_aggregate_spectrogram(spec, freqs)
    assert got.device.type == "cuda"
    ref, names_h, _ = TF.band_aggregate_spectrogram(spec.cpu().numpy(),
                                                    freqs)
    assert names == names_h
    np.testing.assert_allclose(got.cpu().numpy(), ref, rtol=1e-6, atol=1e-7,
                               equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [False, True])
def test_task_wise_cmc_on_card_runs_the_kernel(cuda, threshold):
    """Kernel B1 at E = 11 against the CPU: fused EMG max, or the full
    grid then the host max.  Coherence within 5e-5, CIs within
    ``ci_tolerance``."""
    rng = np.random.default_rng(7)
    n = 256 * 12
    shared = rng.standard_normal((n, 1))
    eeg = (0.5 * shared + rng.standard_normal((n, 64))).astype(np.float32)
    emg = (0.5 * shared + rng.standard_normal((n, 6))).astype(np.float32)
    mask = np.zeros(11, bool)
    mask[2:9] = True
    kw = dict(eeg_channel_subset=CMC_EEG_CHANNEL_SUBSET,
              window_size_sec=2.0, window_mask=mask,
              enforce_independence_threshold=threshold,
              independence_threshold_alpha=1 - 1e-9)
    before = cuda_msc.msc_jackknife.launches
    got = TF.compute_task_wise_aggregated_cmc(eeg, emg, 256, "flexor",
                                              device=cuda, **kw)
    assert cuda_msc.msc_jackknife.launches > before
    ref = TF.compute_task_wise_aggregated_cmc(eeg, emg, 256, "flexor",
                                              device="cpu", **kw)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=5e-5)
    sub = eeg[:, [TF.EEG_CHANNEL_IND_DICT[c]
                  for c in CMC_EEG_CHANNEL_SUBSET]]
    starts, _ = window_grid(n, 512, 256, 256.0)
    tapers = t32(filtered_tapers(512, 3, 0.9))
    e, m = (TC.tapered_rfft(frame_signal(t32(x), starts, 512), tapers)
            for x in (sub, emg))
    tol = cuda_msc.ci_tolerance(
        cuda_msc.loo_coherence_max(e, m).numpy().max(-1))
    for g, r in zip(got[1:3], ref[1:3]):
        assert (np.abs(g - r) <= tol).all()


@pytest.mark.cuda
def test_jackknife_coherence_and_ci_on_card_runs_the_kernel(cuda):
    rng = np.random.default_rng(8)
    shared = rng.standard_normal((256, 1))
    eeg = 0.6 * shared + rng.standard_normal((256, 11))
    emg = 0.6 * shared + rng.standard_normal((256, 64))
    tapers = filtered_tapers(256, 3, 0.9)
    before = cuda_msc.msc_jackknife.launches
    got = TF.jackknife_coherence_and_ci(tapers, eeg, emg, 256.0, 256,
                                        device=cuda)
    assert cuda_msc.msc_jackknife.launches == before + 1
    ref = TF.jackknife_coherence_and_ci(tapers, eeg, emg, 256.0, 256,
                                        device="cpu")
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=5e-5)
    e, m = (TC.tapered_rfft(t32(x)[None], t32(tapers)) for x in (eeg, emg))
    tol = cuda_msc.ci_tolerance(cuda_msc.loo_coherence_max(e, m)[0].numpy())
    for g, r in zip(got[1:], ref[1:]):
        assert (np.abs(g - r) <= tol).all()


@pytest.mark.cuda
def test_phase_null_on_card_matches_cpu(cuda):
    """One seed, so the same phases, on the card and the CPU (the
    threefry kernel draws the CPU's bits): observed within 5e-5,
    max_stat rtol 1e-4 / atol 5e-5, p_fwe equal, quantiles equal but in
    at most 1e-3 of the cells, by one bin.  cuFFT and the CPU's FFT
    differ by ~1e-7, so a cell's quantile moves where its order
    statistic lies that near a bin edge: ~1e-4 to 1e-3 of the cells, so
    the grid has 8 196 cells (2-s windows at 2048 Hz, 2×2) for the
    fraction to mean something."""
    eeg, emg = coupled_signals(fs=2048, seconds=8, n_eeg=2, n_emg=2)
    kw = dict(window_length_sec=2.0, n_surrogates=200, surrogate_chunk=64,
              band=(13.0, 100.0))
    got = TSu.msc_phase_randomized_null(eeg, emg, 2048.0, device=cuda, **kw)
    ref = TSu.msc_phase_randomized_null(eeg, emg, 2048.0, **kw, device="cpu")
    np.testing.assert_allclose(got["observed"], ref["observed"], rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(got["max_stat"], ref["max_stat"], rtol=1e-4,
                               atol=5e-5)
    assert got["p_fwe"] == ref["p_fwe"]
    for q in (0.95, 0.99):
        d = np.abs(got["null_quantiles"][q] - ref["null_quantiles"][q]) * 1024
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3


# ---- the ICA's CUDA-graph epoch on the card -------------------------------

@pytest.mark.cuda
def test_ica_reference_layout_on_card_matches_cpu(cuda):
    """``batch_layout='reference'``: the epoch's permutation drawn on the
    card (threefry kernel, stable sort) equals the CPU's bit for bit, and
    three replayed epochs give the CPU's W within rtol 1e-4."""
    key = prng.split(prng.prng_key(42))[1]
    n = 2 ** 17 + 3
    assert torch.equal(cuda_prng.permutation(key, n, cuda).cpu(),
                       prng.permutation(key, n))
    rng = np.random.default_rng(1)
    xw = rng.laplace(size=(256 * 30, 3)).astype(np.float32)
    w_card, n_card = TI._extended_infomax(
        prng.prng_key(7), torch.from_numpy(xw).to(cuda), 3, 80, 3,
        np.float32(0.003), batch_layout="reference")
    w_cpu, n_cpu = TI._extended_infomax(
        prng.prng_key(7), torch.from_numpy(xw), 3, 80, 3,
        np.float32(0.003), batch_layout="reference")
    assert n_card == n_cpu == 3
    np.testing.assert_allclose(w_card.cpu().numpy(), w_cpu.numpy(),
                               rtol=1e-4,
                               atol=1e-6 * float(w_cpu.abs().max()))


@pytest.mark.cuda
def test_ica_graph_epochs_on_card_match_cpu(cuda):
    """The epoch captured once and replayed on the card against the eager
    epoch on the CPU, on three sources mixed into six channels: the same
    number of epochs (the same threefry shifts), and the same sources up
    to sign and order at |corr| ≥ 0.999."""
    rng = np.random.default_rng(0)
    t = np.arange(256 * 30) / 256
    src = np.stack([np.sign(np.sin(2 * np.pi * 0.7 * t)),
                    np.sin(2 * np.pi * 11 * t + 1.0),
                    rng.laplace(size=len(t))], axis=1)
    x = src @ rng.standard_normal((6, 3)).T + 0.02 * rng.standard_normal(
        (len(t), 6))
    got = TI.InfomaxICA(3, device=cuda).fit(x)
    ref = TI.InfomaxICA(3, device="cpu").fit(x)
    assert got.n_iter_ == ref.n_iter_ < got.max_iter
    assert got.timings_["capture_sec"] > 0
    c = np.abs(np.corrcoef(got.get_sources(x).T, ref.get_sources(x).T)[:3, 3:])
    assert c.max(axis=1).min() >= 0.999


# ---- the statistics stage on the card --------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 300, TL._REML_BLOCK + 5])
def test_reml_core_on_card_matches_cpu(cuda, S):
    """The batched REML on the card against the CPU: β within 1e-2 of its
    SE (chip_smoke.REML_BETA_SE: two float32 solves of such a design, as
    the port and the JAX package are in tests/test_torch_models.py;
    cuBLAS, MKL and the atomic group sums round differently), SE and
    scale within rtol 2e-3; a block edge at S = 8 197."""
    rng = np.random.default_rng(S)
    n_subj, n_per = 12, 10
    groups = np.repeat(np.arange(n_subj), n_per)
    n = n_subj * n_per
    X = np.column_stack([np.ones(n), rng.uniform(20, 60, n),
                         np.tile(np.arange(n_per), n_subj),
                         rng.random((n, 3)) < 0.3])
    Y = (0.9 + 1e-4 * X[:, 1] + rng.normal(0, 0.02, (S, n_subj))[:, groups]
         + rng.normal(0, 0.015, (S, n)))
    got = TL.batched_lme_pvalues(X, Y, groups, device=cuda)
    ref = TL.batched_lme_pvalues(X, Y, groups, device="cpu")
    assert np.isfinite(got["pvalues"]).all()
    assert np.max(np.abs(got["beta"] - ref["beta"]) / ref["bse"]) <= 1e-2
    np.testing.assert_allclose(got["bse"], ref["bse"], rtol=2e-3)
    np.testing.assert_allclose(got["scale"], ref["scale"], rtol=2e-3)


@pytest.mark.cuda
def test_weighted_reml_on_card_matches_cpu(cuda):
    """The bootstrap's solver, B = 200 with 20 % absent rows: β within
    1 % of β's spread over the resamples."""
    rng = np.random.default_rng(1)
    B, G, m = 200, 12, 12
    gidx = np.repeat(np.arange(G), m)
    x = (rng.random((B, G * m)) < 0.5).astype(np.float32)
    y = (0.9 + 0.01 * x + rng.normal(0, 0.02, x.shape)
         + rng.normal(0, 0.01, (B, G))[:, gidx]).astype(np.float32)
    w = (rng.random(x.shape) > 0.2).astype(np.float32)
    Xb = np.stack([np.ones_like(x), x], 2)
    got, ref = (TL._batched_reml_weighted(
        *(torch.from_numpy(a).to(dev) for a in (Xb, y, w,
                                               gidx.astype(np.int64))),
        n_groups=G).cpu().numpy() for dev in (cuda, "cpu"))
    assert np.max(np.abs(got - ref) / ref.std(0)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("tail", [-1, 0, 1])
def test_cluster_null_on_card_matches_cpu(cuda, tail):
    """The sign matrices bit for bit (the threefry kernel), H0 within
    rtol/atol 1e-4, and in exact mode the cluster p-values equal."""
    rng = np.random.default_rng(tail + 5)
    X = rng.standard_normal((12, 20, 11)).astype(np.float32)
    X[:, 5:12, 2:6] += 1.2 * (tail or 1)
    adj = TPerm.combine_adjacency(
        20, TPerm.delaunay_channel_adjacency(CMC_EEG_CHANNEL_SUBSET))
    before = cuda_prng.threefry_draw.launches
    signs = TPerm._draw_signs(9, 3, 100, 12, cuda)
    assert cuda_prng.threefry_draw.launches == before + 1
    assert torch.equal(signs.cpu(), TPerm._draw_signs(9, 3, 100, 12, "cpu"))
    got, ref = (TPerm.cluster_permutation_1samp_test(
        X, adj, n_permutations=300, tail=tail, seed=9,
        permutation_chunk=100, device=dev) for dev in (cuda, "cpu"))
    np.testing.assert_allclose(got[3], ref[3], rtol=1e-4, atol=1e-4)
    got, ref = (TPerm.cluster_permutation_1samp_test(
        X[:8], adj, n_permutations=256, tail=tail, device=dev)
        for dev in (cuda, "cpu"))
    assert len(got[3]) == 256
    np.testing.assert_array_equal(got[2], ref[2])
