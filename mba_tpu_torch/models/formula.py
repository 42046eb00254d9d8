"""Minimal formula engine (patsy replacement).

The reference builds patsy formulas from condition/explanatory variable
specs with ``C()``/``Q()`` quoting and ``A:B`` moderation interactions
(statistical_modelling.py:133-175, 434-472).  patsy is not available here;
this module produces the design matrix directly while emitting the exact
patsy parameter-name conventions the downstream reporting code parses:

- ``Intercept``
- ``C(Var)[T.level]`` / ``C(Q('Var name'))[T.level]`` — treatment-coded
  categoricals (reference level = first pandas category)
- ``Var`` / ``Q('Var name')`` — numeric terms
- ``A:B`` interactions with each side formatted as above

A copy of ``mba_tpu/models/formula.py`` (numpy and pandas), since the port
never imports ``mba_tpu``.
"""
from __future__ import annotations

import numpy as np
import pandas as pd


def _quote(name: str) -> str:
    return f"Q('{name}')" if " " in name else name


def _term_label(name: str, is_categorical: bool) -> str:
    q = _quote(name)
    return f"C({q})" if is_categorical else q


def apply_reference_categories(df: pd.DataFrame, condition_vars: dict,
                               reference_categories: dict | None
                               ) -> pd.DataFrame:
    """Reorder categorical levels so the reference level comes first.

    Parity: reference statistical_modelling.py:17-70.
    """
    if not reference_categories:
        return df
    for var_name, var_type in condition_vars.items():
        if var_type != "categorical" or var_name not in reference_categories:
            continue
        ref = reference_categories[var_name]
        if not isinstance(df[var_name].dtype, pd.CategoricalDtype):
            df[var_name] = df[var_name].astype("category")
        current = df[var_name].cat.categories.tolist()
        if ref not in current:
            print(f"  [WARN] '{ref}' not found in '{var_name}'. "
                  f"Available: {current}. Using alphabetical default.")
        else:
            others = sorted(c for c in current if c != ref)
            df[var_name] = df[var_name].cat.reorder_categories([ref]
                                                               + others)
    return df


def build_formula(response_var: str, condition_vars: dict,
                  explanatory_vars: list,
                  moderation_pairs: list | None = None) -> str:
    """Patsy-style formula string (display/reporting parity)."""
    parts = []
    for var_name, var_type in condition_vars.items():
        if var_type == "categorical":
            parts.append(_term_label(var_name, True))
        elif var_type == "ordinal":
            parts.append(_quote(var_name))
        else:
            raise ValueError(f"Unknown variable type: {var_type}")
    parts += [_quote(v) for v in explanatory_vars]
    if moderation_pairs:
        for moderated, moderating in moderation_pairs:
            mod_fmt = _term_label(
                moderated, condition_vars.get(moderated) == "categorical")
            ing_fmt = _term_label(
                moderating, condition_vars.get(moderating) == "categorical")
            if (moderating not in condition_vars
                    and moderating not in explanatory_vars
                    and ing_fmt not in parts):
                parts.append(ing_fmt)
            parts.append(f"{mod_fmt}:{ing_fmt}")
    return response_var + " ~ " + " + ".join(parts)


def _encode_term(df: pd.DataFrame, name: str, is_categorical: bool):
    """→ (columns (n, k) float array, per-column patsy labels)."""
    if is_categorical:
        cat = df[name]
        if not isinstance(cat.dtype, pd.CategoricalDtype):
            cat = cat.astype("category")
        levels = cat.cat.categories.tolist()
        codes = cat.cat.codes.to_numpy()
        base = _term_label(name, True)
        cols, labels = [], []
        for j, level in enumerate(levels[1:], start=1):  # drop reference
            cols.append((codes == j).astype(float))
            labels.append(f"{base}[T.{level}]")
        return (np.stack(cols, axis=1) if cols
                else np.zeros((len(df), 0))), labels
    values = pd.to_numeric(df[name], errors="coerce").to_numpy(float)
    return values[:, None], [_quote(name)]


def build_design_matrix(df: pd.DataFrame, condition_vars: dict,
                        explanatory_vars: list,
                        moderation_pairs: list | None = None,
                        reference_categories: dict | None = None,
                        ) -> tuple[np.ndarray, list[str]]:
    """Treatment-coded design matrix with patsy-convention column names."""
    df = apply_reference_categories(df.copy(), condition_vars,
                                    reference_categories)
    n = len(df)
    columns = [np.ones((n, 1))]
    names = ["Intercept"]
    term_cache: dict[str, tuple[np.ndarray, list[str]]] = {}

    def encoded(name: str, is_cat: bool):
        key = (name, is_cat)
        if key not in term_cache:
            term_cache[key] = _encode_term(df, name, is_cat)
        return term_cache[key]

    main_terms: list[tuple[str, bool]] = []
    for var_name, var_type in condition_vars.items():
        if var_type not in ("categorical", "ordinal"):
            raise ValueError(f"Unknown variable type: {var_type}")
        main_terms.append((var_name, var_type == "categorical"))
    for var in explanatory_vars:
        main_terms.append((var, False))

    interaction_terms: list[tuple[tuple[str, bool], tuple[str, bool]]] = []
    if moderation_pairs:
        present = {t[0] for t in main_terms}
        for moderated, moderating in moderation_pairs:
            ing_cat = condition_vars.get(moderating) == "categorical"
            if moderating not in present:
                main_terms.append((moderating, ing_cat))
                present.add(moderating)
            mod_cat = condition_vars.get(moderated) == "categorical"
            interaction_terms.append(((moderated, mod_cat),
                                      (moderating, ing_cat)))

    for name, is_cat in main_terms:
        cols, labels = encoded(name, is_cat)
        columns.append(cols)
        names.extend(labels)

    for (a_name, a_cat), (b_name, b_cat) in interaction_terms:
        a_cols, a_labels = encoded(a_name, a_cat)
        b_cols, b_labels = encoded(b_name, b_cat)
        for i, la in enumerate(a_labels):
            for j, lb in enumerate(b_labels):
                columns.append((a_cols[:, i] * b_cols[:, j])[:, None])
                names.append(f"{la}:{lb}")

    X = np.concatenate(columns, axis=1)
    return X, names
