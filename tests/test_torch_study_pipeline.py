"""The study pipeline of ``mba_tpu_torch`` against ``mba_tpu``, end to end
on the CPU: the feature stage ``run_subject`` (s3), the Combined
Statistics frames (s4), the RQ-A omnibus and the CBPA batch (s5).

The tree is ``tests/_torch_study.py``'s: 4 subjects, 10 trials of 20 s at
128 Hz, 64 EEG channels and two 4-channel EMG grids with a planted beta
drive, laid out by the port's ``tools/synth_study``.  Each package runs
s3 on its own copy of the tree.  Stated tolerances:

- s3: log10 PSD spectrograms atol 1e-4, task-wise CMC atol MSC_ATOL =
  5e-5 (``tests/test_torch_signal_features.py``); the enriched serial
  frame equal;
- s4 on each package's own artifacts: the CMC columns within MSC_ATOL,
  the PSD columns within 1e-4, every other column equal;
- s4 of one package on the other's artifacts: the frame equal to that
  package's own s4 there (the host code is a copy);
- the omnibus on one frame (4 of the 14 RQ-A hypotheses, both
  resolutions, all levels): every coefficient and p-value within 1e-6
  relative, the Level-0 music effect among them;
- the CBPA on one tree (128 permutations; 2^4 sign flips, so exact): the
  observed t-map within 1e-5, the same clusters, the cluster p-values
  equal to the float64 oracle of tests/test_stats_golden.py and to the
  JAX package's but at its largest cluster (ROADMAP C10).
"""
import shutil
import warnings

import numpy as np
import pandas as pd
import pytest
import torch

from mba_tpu.pipeline import cbpa as JCB
from mba_tpu.pipeline import signal_features as JF
from mba_tpu.workflows import statistics_data_preparation_workflow as JSD
from mba_tpu.workflows import statistics_RQ_A_omnibus_testing_workflow as JA
from mba_tpu.workflows import subject_feature_extraction_workflow as JSF
from mba_tpu.workflows.paths import StudyPaths as JPaths
from mba_tpu_torch.pipeline import cbpa as TCB
from mba_tpu_torch.pipeline import signal_features as TF
from mba_tpu_torch.utils import file_management as filemgmt
from mba_tpu_torch.workflows import statistics_data_preparation_workflow \
    as TSD
from mba_tpu_torch.workflows import statistics_RQ_A_omnibus_testing_workflow \
    as TA
from mba_tpu_torch.workflows import subject_feature_extraction_workflow \
    as TSF
from mba_tpu_torch.workflows.paths import StudyPaths as TPaths

from _torch_study import assert_same, write_small_study
from test_stats_golden import _mne_semantics_oracle

torch.set_num_threads(1)

N_SUBJECTS = 4
SEGMENTS = (1, 2)
MSC_ATOL = 5e-5
LOG_PSD_ATOL = 1e-4
COEF_RTOL = 1e-6
T_OBS_ATOL = 1e-5
CBPA_PERMUTATIONS = 128
LEVEL0_PARAMETER = "Music Listening"
# one CMC and one PSD hypothesis of each kind the frames hold (the study
# phase of chip_smoke.py runs all 14)
OMNIBUS_HYPOTHESES = [TA.RQA_HYPOTHESES[i] for i in (0, 5, 8, 12)]


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One small study, s3 run on it by each package in its own copy."""
    base = tmp_path_factory.mktemp("study")
    study = write_small_study(base / "port", N_SUBJECTS)
    shutil.copytree(base / "port", base / "jax")
    for subject in range(N_SUBJECTS):
        TSF.run_subject(subject, TPaths(base / "port"),
                        sampling_freq=study["fs"], device="cpu")
        JSF.run_subject(subject, JPaths(base / "jax"),
                        sampling_freq=study["fs"])
    return {"port": base / "port", "jax": base / "jax",
            "lookup": study["lookup"]}


def _dirs(root, subject):
    sub = f"subject_{subject:02}"
    return (root / "data" / "experiment_results" / sub,
            root / "data" / "precomputed_features" / sub)


def _frames(workflow, root, lookup):
    cache: dict = {}
    return {n: workflow.build_combined_statistics_frame(
        list(range(N_SUBJECTS)), root / "data" / "experiment_results",
        root / "data" / "precomputed_features", n,
        music_lookup_table_path=lookup, input_cache=cache, save=False)
        for n in SEGMENTS}


@pytest.fixture(scope="module")
def frames(trees):
    """s4 of each package (key 0) on each package's artifacts (key 1)."""
    return {(name, tree): _frames(workflow, trees[tree], trees["lookup"])
            for name, workflow in (("port", TSD), ("jax", JSD))
            for tree in ("port", "jax")}


@pytest.mark.parametrize("subject", range(N_SUBJECTS))
def test_run_subject_artifacts_match_jax(trees, subject):
    exp_port, feat_port = _dirs(trees["port"], subject)
    exp_jax, feat_jax = _dirs(trees["jax"], subject)
    for modality in ("eeg", "emg_1_flexor", "emg_2_extensor"):
        got = TF.fetch_stored_spectrograms(feat_port, "PSD", modality)
        ref = JF.fetch_stored_spectrograms(feat_jax, "PSD", modality)
        assert got[0].shape == ref[0].shape and got[0].dtype == np.float32
        np.testing.assert_allclose(got[0], ref[0], rtol=0,
                                   atol=LOG_PSD_ATOL)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])
    for muscle in ("Flexor", "Extensor"):
        got = TF.fetch_stored_spectrograms(feat_port, "CMC", muscle)
        ref = JF.fetch_stored_spectrograms(feat_jax, "CMC", muscle)
        assert got[0].shape == ref[0].shape and (got[0] > 0).any()
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=MSC_ATOL)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])
    names = {}
    for tag, exp in (("port", exp_port), ("jax", exp_jax)):
        path = filemgmt.most_recent_file(exp / "serial_measurements", ".csv",
                                         ["Enriched Serial Frame"])
        names[tag] = path.name[20:]
        names[tag + "_text"] = path.read_text()
    assert names["port"] == names["jax"]
    assert names["port_text"] == names["jax_text"]


@pytest.mark.parametrize("n_seg", SEGMENTS)
def test_statistics_frames_match_jax(frames, n_seg):
    port = frames[("port", "port")][n_seg]
    ref = frames[("jax", "jax")][n_seg]
    assert list(port.columns) == list(ref.columns)
    assert len(port) == N_SUBJECTS * 10 * n_seg
    cmc = [c for c in port.columns if c.startswith("CMC_")]
    psd = [c for c in port.columns if c.startswith("PSD_")]
    assert len(cmc) == 8 and len(psd) == 6
    assert port[cmc + psd].notna().all().all()
    np.testing.assert_allclose(port[cmc].to_numpy(float),
                               ref[cmc].to_numpy(float), rtol=0,
                               atol=MSC_ATOL)
    np.testing.assert_allclose(port[psd].to_numpy(float),
                               ref[psd].to_numpy(float), rtol=0,
                               atol=LOG_PSD_ATOL)
    rest = [c for c in port.columns if c not in cmc + psd]
    pd.testing.assert_frame_equal(port[rest], ref[rest])


@pytest.mark.parametrize("artifacts", ["port", "jax"])
def test_each_package_reads_the_others_artifacts(frames, artifacts):
    """s4 of both packages on one package's s3 artifacts: one frame."""
    port = frames[("port", artifacts)]
    ref = frames[("jax", artifacts)]
    for n_seg in SEGMENTS:
        pd.testing.assert_frame_equal(port[n_seg], ref[n_seg])


@pytest.fixture(scope="module")
def omnibus_dir(tmp_path_factory):
    """The omnibus workflows' output directories, one per package."""
    return tmp_path_factory.mktemp("omnibus")


@pytest.fixture(scope="module")
def omnibus(trees, frames, omnibus_dir):
    """Both packages' omnibus on the port's s4 frames, saved as
    ``build_combined_statistics_frame(save=True)`` saves them."""
    out = omnibus_dir
    feat = trees["port"] / "data" / "precomputed_features"
    for n_seg, frame in frames[("port", "port")].items():
        frame.to_csv(feat / filemgmt.file_title(
            f"Combined Statistics {n_seg}seg", ".csv"), index=False)
    return {name: workflow.run_omnibus(
        feat, out / name, n_within_trial_segments_list=SEGMENTS,
        hypotheses=OMNIBUS_HYPOTHESES, make_forest_mosaics=False)
        for name, workflow in (("port", TA), ("jax", JA))}


def _level0(combined):
    return combined[
        (combined["Hypothesis"] == "H1: Flexor Beta Peak CMC")
        & combined["Comparison_Level"].astype(str).str.startswith("Level 0")
        & (combined["N. Segments"] == 1)
        & (combined["Model_Type"] == "LME")
        & combined["Parameter"].astype(str).str.contains(LEVEL0_PARAMETER)
        & ~combined["Parameter"].astype(str).str.contains(":")]


def test_omnibus_matches_jax(omnibus):
    port, ref = omnibus["port"], omnibus["jax"]
    assert len(port) == len(ref) and len(port) > 0
    key = ["Hypothesis", "Comparison_Level", "N. Segments", "Model_Type",
           "Parameter"]
    pd.testing.assert_frame_equal(port[key], ref[key])
    for col in ("Coefficient", "p_value", "p_value_fdr"):
        np.testing.assert_allclose(port[col].to_numpy(float),
                                   ref[col].to_numpy(float), rtol=COEF_RTOL,
                                   atol=0, equal_nan=True, err_msg=col)
    lvl0_port, lvl0_ref = _level0(port), _level0(ref)
    assert len(lvl0_port) == 1
    np.testing.assert_allclose(lvl0_port["Coefficient"].to_numpy(float),
                               lvl0_ref["Coefficient"].to_numpy(float),
                               rtol=COEF_RTOL, atol=0)


def _cbpa_configs(module, root, **extra):
    return [module.CBPAConfig(
        modality="CMC", modality_file_id="Flexor", freq_band="beta",
        condition_A="Happy", condition_B="Silence",
        n_permutations=CBPA_PERMUTATIONS, tail=1, data_root=root,
        output_dir=root / f"cbpa_{module.__name__.split('.')[0]}",
        hypothesis_label="cbpa_cmc_happy_vs_silence", save_plots=False,
        **extra), module.CBPAConfig(
        modality="PSD", modality_file_id="eeg", freq_band="alpha",
        condition_A="Happy", condition_B="Silence",
        n_permutations=CBPA_PERMUTATIONS, tail=0, data_root=root,
        output_dir=root / f"cbpa_{module.__name__.split('.')[0]}",
        hypothesis_label="cbpa_psd_happy_vs_silence", save_plots=False,
        **extra)]


def _oracle_pv(cfg, result):
    """Cluster p-values of the float64 numpy oracle of
    tests/test_stats_golden.py on the run's own contrast, by cluster."""
    X, ch_names, _ = TCB.build_contrast_array(cfg)
    X = np.nan_to_num(np.asarray(X, np.float32))
    adjacency = TCB._build_adjacency(ch_names, X.shape[1])
    obs, pv, _ = _mne_semantics_oracle(X, adjacency, cfg.tail,
                                       cfg.alpha_cluster_forming)
    by_nodes = {frozenset(nodes.tolist()): p for (nodes, _), p in
                zip(obs, pv)}
    return np.array([by_nodes[frozenset(np.flatnonzero(c.ravel()).tolist())]
                     for c in result["clusters"]])


def test_cbpa_batch_matches_jax(trees, omnibus):
    """The two contrasts of the study's CBPA phase, from the stored
    spectrograms of the port's tree (its s4 frame names the conditions).
    2^4 ≤ 128: both packages enumerate every sign assignment, and the
    port's cluster p-values equal the oracle's.  The JAX package's equal
    them too, but at the largest cluster, where its device t-map can
    round the identity's statistic under the observed one and drop it
    from H0 (ROADMAP C10): there it may lie 1/16 or, two-tailed, 2/16
    lower."""
    root = trees["port"]
    cfgs = _cbpa_configs(TCB, root, device="cpu")
    port, port_rows = TCB.run_batch(cfgs)
    ref, ref_rows = JCB.run_batch(_cbpa_configs(JCB, root))
    step = 2.0 ** -N_SUBJECTS
    for cfg, got, want in zip(cfgs, port, ref):
        assert got["t_obs"].shape == want["t_obs"].shape
        assert got["ch_names"] == want["ch_names"]
        np.testing.assert_array_equal(got["time_grid"], want["time_grid"])
        np.testing.assert_allclose(got["t_obs"], np.asarray(want["t_obs"]),
                                   rtol=0, atol=T_OBS_ATOL)
        assert len(got["clusters"]) == len(want["clusters"]) > 0
        for a, b in zip(got["clusters"], want["clusters"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["cluster_pv"],
                                      _oracle_pv(cfg, got))
        assert got["cluster_pv"].min() >= step
        masses = np.array([abs(float(got["t_obs"][c].sum()))
                           for c in got["clusters"]])
        top = masses == masses.max()
        np.testing.assert_array_equal(got["cluster_pv"][~top],
                                      want["cluster_pv"][~top])
        gap = (got["cluster_pv"] - want["cluster_pv"])[top] / step
        assert set(np.round(gap).tolist()) <= {0.0, 1.0, 2.0}
    assert (port[0]["t_obs"] > port[0]["t_thresh"]).any()
    key = [c for c in port_rows.columns
           if c not in ("p_value", "significant")]
    pd.testing.assert_frame_equal(port_rows[key], ref_rows[key])
    assert (port_rows["significant"] == (port_rows["p_value"] < 0.05)).all()


@pytest.mark.parametrize("modality,file_id,phase", [
    ("CMC", "Flexor", True), ("CMC", "Extensor", False),
    ("PSD", "emg_1_flexor", True)])
def test_phase_average_maps_match_jax(trees, modality, file_id, phase):
    """The post-hoc figures' data: cohort phase (or time) maps from the
    stored spectrograms, equal to the JAX package's (host numpy on the
    same artifacts)."""
    kw = dict(modality=modality, modality_file_id=file_id, freq_band="beta",
              condition_A="_", condition_B="_",
              use_phase_normalization=phase, n_phase_bins=12,
              phase_start_offset_sec=0.0, data_root=trees["port"],
              save_plots=False)
    subjects = list(range(N_SUBJECTS))
    got = TCB.assemble_phase_average_maps(TCB.CBPAConfig(**kw), subjects)
    want = JCB.assemble_phase_average_maps(JCB.CBPAConfig(**kw), subjects)
    assert_same(got, want)
    assert np.isfinite(got[1]).any()


def test_accuracy_phase_profiles_match_jax(tmp_path):
    """Accuracy profiles per condition, on logs and accuracy traces of the
    study's own 45-s trials (``tools/synth_study`` at its defaults), where
    the 5.5-s accuracy offset leaves full force cycles."""
    from mba_tpu_torch.tools import synth_study as S
    plan = S.TrialPlan(10)
    for subject in range(2):
        S.write_subject_tree(tmp_path, subject, plan, write_raw_serial=False)
    kw = dict(modality="CMC", n_phase_bins=12, min_samples_per_cycle=2)
    got = TCB.assemble_accuracy_phase_profiles(TCB.CBPAConfig(**kw),
                                               tmp_path, [0, 1])
    want = JCB.assemble_accuracy_phase_profiles(JCB.CBPAConfig(**kw),
                                                tmp_path, [0, 1])
    assert_same(got, want)
    assert sum(len(v) for v in got.values()) >= 20


def test_post_hoc_workflow_matches_jax(trees, omnibus, tmp_path):
    """The RQ-A post-hoc workflow: its CBPA batch configs are the JAX
    package's (plus ``device``); its phase-average figures draw from the
    same maps (over time: the study's 20-s trials hold no full force cycle
    after the default one-cycle offset)."""
    from mba_tpu.workflows import \
        statistics_RQ_A_post_hoc_testing_workflow as JPH
    from mba_tpu_torch.workflows import \
        statistics_RQ_A_post_hoc_testing_workflow as TPH
    root = trees["port"]
    got = TPH.build_cbpa_configs(root, tmp_path, n_permutations=64,
                                 device="cpu")
    want = JPH.build_cbpa_configs(root, tmp_path, n_permutations=64)
    assert len(got) == len(want) == 16
    for a, b in zip(got, want):
        fields = dict(a.__dict__)
        assert fields.pop("device") == "cpu"
        assert fields == b.__dict__
    exp = root / "data" / "experiment_results"
    figs = {}
    for name, mod in (("port", TPH), ("jax", JPH)):
        out = tmp_path / name
        figs[name] = (mod.make_phase_average_figures(
            root, out, exp, list(range(N_SUBJECTS)),
            use_phase_normalization=False, n_phase_bins=12),
            sorted(p.name[20:] for p in out.glob("*.png")))
    assert_same(figs["port"], figs["jax"])
    assert len(figs["port"][1]) == 2
    assert "NotImplementedError" not in TPH.__doc__


HETEROGENEITY_CSVS = ("Heterogeneity Responder Summary",
                      "Heterogeneity MI Results Raw",
                      "Heterogeneity MI Summary",
                      "Heterogeneity Subject Clusters",
                      "Heterogeneity Silhouette Scores")


@pytest.fixture(scope="module")
def post_hoc(trees, omnibus, omnibus_dir, tmp_path_factory):
    """``run_post_hoc`` of each package, the port's with ``device="cpu"``,
    on the port's omnibus directory completed with the LOSO influence and
    the subject-effect summary of the port's omnibus results.

    At its defaults it stops in the CBPA batch on this tree, the same in
    both packages: the study's 20-s trials hold no full force cycle after
    the one-cycle offset, so no subject gives a phase-normalised contrast
    (and the synthetic study plays no "Groovy" trial).  So each package
    first runs the batch's contrasts of the categories the study plays
    over time (12 of 16; 1 000 permutations, so every sign flip of 4
    subjects) into its output directory, then ``run_post_hoc`` at its
    defaults but for the batch: the phase figures and the heterogeneity
    modelling."""
    from mba_tpu.workflows import \
        statistics_RQ_A_post_hoc_testing_workflow as JPH
    from mba_tpu_torch.pipeline import statistical_modelling as TStat
    from mba_tpu_torch.workflows import \
        statistics_RQ_A_post_hoc_testing_workflow as TPH
    root = trees["port"]
    feat = root / "data" / "precomputed_features"
    exp = root / "data" / "experiment_results"
    stats_dir = omnibus_dir / "port"
    TStat.run_influence_analysis([("CMC_Flexor_max_beta", 1, 1)],
                                 omnibus["port"], feat, stats_dir,
                                 TA.fetch_level_definitions)
    base = pd.read_csv(filemgmt.most_recent_file(
        feat, ".csv", ["Combined Statistics 1seg"]))
    TStat.create_subject_effect_summary(
        omnibus["port"].to_dict("records"), base, stats_dir,
        TA.fetch_level_definitions(False))
    out = tmp_path_factory.mktemp("post_hoc")
    for name, mod, kw in (("port", TPH, {"device": "cpu"}), ("jax", JPH, {})):
        with pytest.raises(RuntimeError, match="No valid subjects"):
            mod.run_post_hoc(root, out / "defaults", stats_dir, exp, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            mod.run_batch([c for c in mod.build_cbpa_configs(
                root, out / name, use_phase_normalization=False, **kw)
                if c.condition_A != "Groovy"])
            mod.run_post_hoc(root, out / name, stats_dir, exp,
                             run_cbpa_batch=False, **kw)
    return {"port": out / "port", "jax": out / "jax", "omnibus": stats_dir}


def _newest(directory, name):
    path = filemgmt.most_recent_file(directory, ".csv", [name])
    return pd.read_csv(path) if path.stat().st_size > 1 else pd.DataFrame()


@pytest.mark.parametrize("name", HETEROGENEITY_CSVS)
def test_post_hoc_heterogeneity_matches_jax(post_hoc, name):
    """``run_post_hoc`` at its defaults runs the heterogeneity modelling:
    each of its CSVs equal to the JAX package's, exactly.  With 4
    subjects no MI score reaches the summary's 0.05 and no k keeps two
    subjects a cluster (the fallback k = 2 has no silhouette), so those
    two CSVs are empty in both packages.  The Level-0 rows count no
    subject in either (ROADMAP C12): the summary's bool conditions come
    back from its CSV as the strings 'True'/'False'."""
    got, want = (_newest(post_hoc[k], name) for k in ("port", "jax"))
    pd.testing.assert_frame_equal(got, want)
    if name in ("Heterogeneity MI Summary", "Heterogeneity Silhouette Scores"):
        assert got.empty
    else:
        assert len(got) > 0
    if name == "Heterogeneity Responder Summary":
        assert (got.loc[got["Level"] == "lvl_0", "N_Subjects"] == 0).all()
        happy = got[(got["Condition"] == "Happy")
                    & (got["Dependent_Variable"] == "CMC_Flexor_max_beta")]
        assert happy["N_Subjects"].tolist() == [N_SUBJECTS]
    if name == "Heterogeneity Subject Clusters":
        assert sorted(got["Subject_ID"]) == list(range(N_SUBJECTS))
        assert got["Cluster"].nunique() == 2
    figures = sorted(p.name[20:] for p in post_hoc["port"].glob(
        "*Heterogeneity*.png"))
    assert figures == sorted(p.name[20:] for p in post_hoc["jax"].glob(
        "*Heterogeneity*.png")) == ["Heterogeneity Combined Clustering.png"]


def test_post_hoc_report_matches_jax(post_hoc, tmp_path):
    """``build_report`` of each package on the shared omnibus directory:
    on one post-hoc directory, one Markdown text, line 2 (the timestamp)
    masked.  On each package's own post-hoc outputs the texts differ only
    in CBPA rows, where the JAX package's cluster p-value can be lower at
    a contrast's largest cluster (ROADMAP C10); the two CBPA summaries
    agree in every other column."""
    from mba_tpu.workflows import statistics_report_workflow as JRW
    from mba_tpu_torch.workflows import statistics_report_workflow as TRW

    def report(module, levels, post_hoc_dir, name):
        path = module.build_report(
            post_hoc["omnibus"], post_hoc_dir, tmp_path / name, "RQ_A",
            level_definitions=levels.fetch_level_definitions(False),
            fdr_levels_to_correct=[2, 3])
        lines = path.read_text(encoding="utf-8").splitlines()
        assert lines[1].startswith("*Generated: ")
        return lines[:1] + lines[2:]

    texts = {name: report(module, levels, post_hoc["port"], name)
             for name, module, levels in (("port", TRW, TA),
                                          ("jax", JRW, JA))}
    assert texts["port"] == texts["jax"]
    own = report(JRW, JA, post_hoc["jax"], "jax_own")
    assert len(own) == len(texts["port"])
    differ = [(a, b) for a, b in zip(texts["port"], own) if a != b]
    assert all(a.startswith("| CMC_") and b.startswith("| CMC_")
               for a, b in differ)
    cbpa = [_newest(post_hoc[k], "CBPA Combined Cluster Summary")
            for k in ("port", "jax")]
    rest = [c for c in cbpa[0].columns if c not in ("p_value", "significant")]
    pd.testing.assert_frame_equal(cbpa[0][rest], cbpa[1][rest])
    body = "\n".join(texts["port"])
    for section in ("## Comparison Levels", "## Subject Clusters",
                    "### CBPA clusters", "### Subject heterogeneity"):
        assert section in body, section
    for hypothesis, _ in OMNIBUS_HYPOTHESES:
        assert texts["port"].count(f"## {hypothesis}") == 1, hypothesis


def test_cbpa_figure_is_drawn(trees, omnibus, tmp_path):
    """``save_plots=True`` draws the t-map figure through the port's
    ``visualizations.plot_cbpa_results``, as the JAX package's does."""
    cfg = _cbpa_configs(TCB, trees["port"], device="cpu")[0]
    cfg.output_dir, cfg.save_plots = tmp_path, True
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TCB.run_cbpa(cfg)
    assert len(list(tmp_path.glob("*CBPA cbpa_cmc_happy_vs_silence.png"))) \
        == 1
