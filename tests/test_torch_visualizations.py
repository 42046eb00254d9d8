"""The figures the port gained with the rest of ``pipeline/
visualizations.py`` (``mba_tpu_torch``) against ``mba_tpu``'s: each
draws on the same inputs, saves under the same file names, and returns
the same kind of result (the same axes and lines, the same flow table of
the category Sankey).  The electrode tables are the JAX package's.
"""
import numpy as np
import pandas as pd
import pytest

from mba_tpu.pipeline import visualizations as JV
from mba_tpu_torch.pipeline import visualizations as TV

from test_viz_families import combined_frame, results_frame  # noqa: F401


def _profiles(grid):
    return {"Happy": [np.sin(np.deg2rad(grid))] * 4,
            "Silence": [np.cos(np.deg2rad(grid)).reshape(-1, 1)] * 3}


def _calls(results, combined):
    """Each newly ported plot: name → call(module, save_dir)."""
    rng = np.random.default_rng(0)
    spec = rng.random((50, 30))
    phases = pd.Series(["Calibration"] * 10 + [None] * 5
                       + ["Music Trial"] * 25 + ["Idle State"] * 10,
                       index=pd.date_range("2026-01-01", periods=50,
                                           freq="1s"))
    grid = np.linspace(0, 360, 36, endpoint=False)
    res = results.assign(p_value_adjusted=results["p_value"],
                         p_value_for_plot=results["p_value_fdr"])
    heat = rng.random((64, 5))
    emg_pos = {f"EMG{i:02d}": (float(i % 8), float(i // 8))
               for i in range(16)}
    return {
        "plot_freq_domain": lambda m, d: m.plot_freq_domain(
            rng.random((30, 2)), np.linspace(0, 60, 30), log_scale=True,
            save_dir=d),
        "plot_spectrogram": lambda m, d: m.plot_spectrogram(
            spec, np.arange(50.0), np.linspace(0, 40, 30),
            frequency_range=(5.0, 30.0), save_dir=d),
        "plot_spectrogram_phase_strip": lambda m, d: m.plot_spectrogram(
            spec, np.arange(50.0), np.linspace(0, 40, 30),
            phase_series=phases, title="Phased", save_dir=d),
        "initialise_electrode_heatmap": lambda m, d:
            m.initialise_electrode_heatmap(heat, timestep=2, save_dir=d),
        "initialise_electrode_heatmap_emg": lambda m, d:
            m.initialise_electrode_heatmap(
                heat[:16, 0], positions=emg_pos, add_head_shape=False,
                plot_title="EMG Grid", save_dir=d),
        "plot_psd_avg_with_std": lambda m, d: m.plot_psd_avg_with_std(
            {"alpha": rng.random((40, 3)), "beta": rng.random(40)}, 4.0,
            save_dir=d),
        "animate_electrode_heatmap": lambda m, d:
            m.animate_electrode_heatmap(heat[:, :3], fps=5.0,
                                        save_path=d / "heat.gif"),
        "plot_scatter": lambda m, d: m.plot_scatter(
            rng.random(12), rng.random(12), x_label="Skill",
            y_label="Contrast", category_list=["a", "b"] * 6, save_dir=d),
        "plot_array_with_ci": lambda m, d: m.plot_array_with_ci(
            np.sin(grid), np.sin(grid) - 0.2, np.sin(grid) + 0.2,
            x_axis=grid, hline=0.5, label="x", save_dir=d),
        "plot_hypothesis_forest_mosaic": lambda m, d:
            m.plot_hypothesis_forest_mosaic(
                res, hypotheses=["H2a: CMC beta", "H3: CMC gamma", "H9"],
                output_dir=d, hidden=True, show_title=True,
                file_identifier_suffix="1seg"),
        "plot_cmc_per_category": lambda m, d: m.plot_cmc_per_category(
            {"Happy": rng.random((4, 30)), "Silence": rng.random(30)},
            x_axis=np.linspace(0, 29, 30), save_dir=d),
        "plot_phase_average": lambda m, d: m.plot_phase_average(
            _profiles(grid), grid, show_target_sine=True, save_dir=d),
        "plot_phase_average_plain": lambda m, d: m.plot_phase_average(
            _profiles(grid), grid, title="Plain", save_dir=d),
        "plot_category_reassignment_sankey": lambda m, d:
            m.plot_category_reassignment_sankey(
                pd.DataFrame({"from": ["Happy", "Happy", "Sad", "Classic",
                                       None],
                              "to": ["Groovy", "Happy", "Happy", "Sad",
                                     "Happy"]}),
                rename_dict={"Classic": "Classical"}, output_dir=d),
        "plot_category_sankey": lambda m, d: m.plot_category_sankey(
            ["Happy", "Happy", "Sad", "Sad", "Sad", "Classic"],
            ["Happy", "Groovy", "Sad", "Sad", "Happy", "Classical"],
            rename_dict={"Classical": "Classic"},
            group_dict={"Groovy": "Happy"}, save_dir=d)[1],
        "plot_combined_descriptive_mosaic": lambda m, d:
            m.plot_combined_descriptive_mosaic(
                {"Age": pd.Series([25, 30, 35, 40]),
                 "Skill": pd.Series([1, 2, 3, 4.0]),
                 "Empty": pd.Series(["x", None]),
                 "GSR": pd.Series(rng.random(9)),
                 "HR": pd.Series(rng.random(9)),
                 "Force": pd.Series(rng.random(9))}, save_dir=d),
        "plot_cross_resolution_results": lambda m, d:
            m.plot_cross_resolution_results(
                res, "music[T.True]", "CMC_Flexor_max_beta", save_dir=d),
        "_cmc_threshold": lambda m, d: m._cmc_threshold(5, 0.2),
        "plot_cmc_lineplots_per_category": lambda m, d:
            m.plot_cmc_lineplots_per_category(
                combined, "Category or Silence", "Flexor", "max", 5,
                bands=("beta", "gamma", "theta"), cmc_plot_min=0.2,
                save_dir=d),
        "plot_cmc_lineplots_per_category_list": lambda m, d:
            m.plot_cmc_lineplots_per_category(
                combined, "Category or Silence", "Flexor", "max", 5,
                colormap=["red", "blue"], include_std_dev=False,
                show_significance_threshold=False,
                subject_ids_subset=[0, 1], save_dir=d),
        "plot_cmc_lineplot_normalised": lambda m, d:
            m.plot_cmc_lineplot_normalised(
                combined, "Flexor", "max", 5, save_dir=d),
        "plot_phase_band_subplot": lambda m, d: _phase_strip(m, phases),
    }


def _phase_strip(module, phases):
    plt = TV._pyplot()
    fig, ax = plt.subplots()
    module.plot_phase_band_subplot(ax, phases, (0.0, 49.0))
    out = sorted(t.get_text() for t in ax.texts)
    plt.close(fig)
    return out


NAMES = ["plot_freq_domain", "plot_spectrogram",
         "plot_spectrogram_phase_strip", "initialise_electrode_heatmap",
         "initialise_electrode_heatmap_emg", "plot_psd_avg_with_std",
         "animate_electrode_heatmap", "plot_scatter", "plot_array_with_ci",
         "plot_hypothesis_forest_mosaic", "plot_cmc_per_category",
         "plot_phase_average", "plot_phase_average_plain",
         "plot_category_reassignment_sankey", "plot_category_sankey",
         "plot_combined_descriptive_mosaic",
         "plot_cross_resolution_results", "_cmc_threshold",
         "plot_cmc_lineplots_per_category",
         "plot_cmc_lineplots_per_category_list",
         "plot_cmc_lineplot_normalised", "plot_phase_band_subplot"]


def _summary(out):
    """What a plot returned, comparable across the two packages."""
    if isinstance(out, tuple):
        return tuple(_summary(o) for o in out)
    if isinstance(out, dict):
        return {k: _summary(v) for k, v in out.items()}
    if isinstance(out, pd.DataFrame):
        return out
    if hasattr(out, "axes") and hasattr(out, "savefig"):     # a Figure
        return [(type(a).__name__, len(a.lines), a.get_title())
                for a in out.axes]
    if hasattr(out, "figure") and hasattr(out, "lines"):     # an Axes
        return (len(out.lines), out.get_title(), out.get_xlabel())
    if hasattr(out, "save"):                                 # an animation
        return type(out).__name__
    return out


def test_every_ported_plot_is_listed(results_frame,  # noqa: F811
                                     combined_frame):  # noqa: F811
    assert set(NAMES) == set(_calls(results_frame, combined_frame))
    public = {n for n in dir(JV) if n.startswith(("plot_", "initialise_",
                                                  "animate_", "draw_"))}
    assert public <= {n for n in dir(TV)}


@pytest.mark.parametrize("name", NAMES)
def test_plot_matches_jax(name, results_frame, combined_frame,  # noqa: F811
                          tmp_path):
    out, files = {}, {}
    for tag, module in (("port", TV), ("jax", JV)):
        d = tmp_path / tag
        d.mkdir()
        out[tag] = _summary(_calls(results_frame, combined_frame)[name](
            module, d))
        files[tag] = sorted(p.name[20:] if p.suffix == ".png" else p.name
                            for p in d.iterdir())
    JV.plt.close("all")
    TV._pyplot().close("all")
    assert files["port"] == files["jax"]
    if isinstance(out["port"], pd.DataFrame):
        pd.testing.assert_frame_equal(out["port"], out["jax"])
    else:
        assert out["port"] == out["jax"]
    drawn = name not in ("_cmc_threshold", "plot_phase_band_subplot")
    assert bool(files["port"]) == drawn


def test_category_sankey_flow_counts(tmp_path):
    """The flow table behind the ribbons: intended (rows) by perceived
    (columns), equal to the JAX package's, after renames and groups."""
    src = ["Happy", "Happy", "Sad", "Sad", "Sad", "Classic"]
    tgt = ["Happy", "Groovy", "Sad", "Sad", "Happy", "Classical"]
    kw = dict(rename_dict={"Classical": "Classic"},
              group_dict={"Groovy": "Happy"})
    _, got = TV.plot_category_sankey(src, tgt, save_dir=tmp_path, **kw)
    _, want = JV.plot_category_sankey(src, tgt, **kw)
    pd.testing.assert_frame_equal(got, want)
    assert got.loc["Happy", "Happy"] == 2 and got.loc["Sad", "Sad"] == 2
    assert got.loc["Classic", "Classic"] == 1
    assert int(got.values.sum()) == len(src)
    assert len(list(tmp_path.glob("*Category Reassignment.png"))) == 1


def test_empty_inputs_draw_nothing(capsys):
    for module in (TV, JV):
        assert module.plot_combined_descriptive_mosaic(
            {"x": pd.Series(["a"])}) is None
        assert module.plot_cross_resolution_results(
            pd.DataFrame({"Parameter": ["A"], "Dependent_Variable": ["D"],
                          "Model_Type": ["LME"]}), "A", "D") is None
        assert module.plot_category_reassignment_sankey(
            pd.DataFrame({"from": [None], "to": [None]})) is None
    assert capsys.readouterr().out.count("No category reassignments") == 2
    with pytest.raises(ValueError, match="n_channels, n_timesteps"):
        TV.animate_electrode_heatmap(np.zeros(5))


def test_electrode_tables_match_jax():
    assert TV.EEG_POSITIONS == JV.EEG_POSITIONS
    assert TV.EMG_POSITIONS == JV.EMG_POSITIONS
    assert len(TV.EEG_POSITIONS) == 64
