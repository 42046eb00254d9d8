"""``mba_tpu_torch.models.mediation`` against ``mba_tpu.models.mediation``
on the CPU.

The path fits are copies of the JAX package's host code: equal.  The
bootstrap draws its resamples with numpy's generator as the JAX package
does, so a seed gives both the same resamples; each resample's weighted
REML is float32 on both sides with sums in other orders, so the CI bounds
and the median are held within ``CI_FRAC`` of the CI's width and the
bootstrap p within ``P_DRAWS`` resamples whose indirect effect sits at 0.
"""
import numpy as np
import pandas as pd
import pytest
import torch

from mba_tpu.models import mediation as J
from mba_tpu.workflows import statistics_RQ_A_mediation_analysis_workflow \
    as JW
from mba_tpu_torch.models import mediation as T
from mba_tpu_torch.workflows import \
    statistics_RQ_A_mediation_analysis_workflow as TW

from test_mediation import make_mediation_frame

torch.set_num_threads(1)

CI_FRAC = 1e-2
P_DRAWS = 2
ARGS = ("Category or Silence", ("Happy", "Silence"), "GSR",
        "CMC_Flexor_max_beta")


def _fits(df):
    port, ref = T.fit_mediation_model(df, *ARGS), J.fit_mediation_model(
        df, *ARGS)
    return port, ref


def _boot_close(port, ref, n):
    assert port["bootstrap_status"] == ref["bootstrap_status"] == "computed"
    assert port["bootstrap_success"] == ref["bootstrap_success"] == n
    width = ref["ci_width"]
    for key in ("ci_lower", "ci_upper", "bootstrap_median_indirect"):
        assert abs(port[key] - ref[key]) <= CI_FRAC * width, key
    assert abs(port["bootstrap_p"] - ref["bootstrap_p"]) <= P_DRAWS / n
    assert port["significant"] == ref["significant"]


def test_fit_mediation_model_matches_jax():
    port, ref = _fits(make_mediation_frame())
    assert port.keys() == ref.keys()
    pd.testing.assert_frame_equal(port.pop("model_df"), ref.pop("model_df"))
    assert port == ref


@pytest.mark.parametrize("a,b", [(1.0, 0.8), (0.0, 0.0)])
def test_bootstrap_matches_jax_on_the_same_resamples(a, b):
    """B = 200: a real indirect effect and a null one."""
    port_fit, ref_fit = _fits(make_mediation_frame(a=a, b=b, seed=2))
    port = T.bootstrap_indirect_effect(port_fit, n_bootstrap=200,
                                       device="cpu")
    ref = J.bootstrap_indirect_effect(ref_fit, n_bootstrap=200)
    _boot_close(port, ref, 200)


def test_unfitted_passthrough_matches_jax():
    fit = {"status": "insufficient_data"}
    assert (T.bootstrap_indirect_effect(fit, device="cpu")
            == J.bootstrap_indirect_effect(fit))


def test_mediation_workflow_matches_jax(tmp_path):
    """One configuration end to end: fits, bootstrap, FDR and
    classification, the report table."""
    df = make_mediation_frame()
    feature_dir = tmp_path / "features"
    feature_dir.mkdir()
    df.to_csv(feature_dir / "2024-01-01 10_00_00 Combined Statistics "
              "1seg.csv", index=False)
    hyps = [{"x_var": "Category or Silence",
             "x_contrasts": [("Happy", "Silence")], "m_var": "GSR",
             "y_vars": ["CMC_Flexor_max_beta"]}]
    port = TW.run_mediation_analysis(feature_dir, None, tmp_path / "port",
                                     n_bootstrap=150, hypotheses=hyps,
                                     device="cpu")
    ref = JW.run_mediation_analysis(feature_dir, None, tmp_path / "ref",
                                    n_bootstrap=150, hypotheses=hyps)
    boot = ["ci_lower", "ci_upper", "bootstrap_median_indirect",
            "bootstrap_p", "ci_width"]
    pd.testing.assert_frame_equal(port.drop(columns=boot),
                                  ref.drop(columns=boot))
    _boot_close(port.iloc[0].to_dict(), ref.iloc[0].to_dict(), 150)
    assert len(list((tmp_path / "port").glob("*Report Table.csv"))) == 1
