"""Song-characteristics lookup table.

Parity target: reference ``src/music_feature_extraction_workflow.py``
(431 LoC): audio features per song file (:81-158), Spotify-backed
title/artist/manual-BPM extension (:178-264), perceived-category
reassignment + flow plot (:268-328), clustering + MI + scatters
(:335-431).

Port of ``mba_tpu/workflows/music_feature_extraction_workflow.py``: the
audio features' STFTs run on ``device`` (the card unless ``"cpu"``);
sklearn and matplotlib are imported only inside the functions that use
them.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from mba_tpu_torch.pipeline import music_control as mc
from mba_tpu_torch.utils import file_management as filemgmt


def build_song_characteristics_table(audio_dir: Path,
                                     save_dir: Path | None = None,
                                     duration: float = 120.0,
                                     device=None) -> pd.DataFrame:
    """Compute the feature lookup table over every WAV in a directory."""
    rows = []
    for audio in sorted(Path(audio_dir).glob("*.wav")):
        bpm, flux, centroid, ioi_cv, sync_degree, sync_ratio = \
            mc.compute_all_musical_features(audio, duration=duration,
                                            device=device)
        rows.append({
            "File Title": audio.stem,
            "Title": audio.stem.split(" - ")[0],
            "Artist": (audio.stem.split(" - ")[1]
                       if " - " in audio.stem else "Unknown"),
            "BPM": bpm, "BPM_manual": bpm,
            "Spectral Flux Mean": float(np.mean(flux)),
            "Spectral Flux Std.": float(np.std(flux)),
            "Spectral Centroid Mean": float(np.mean(centroid)),
            "IOI Variance Coeff": ioi_cv,
            "Syncopation Degree": sync_degree,
            "Syncopation Ratio": sync_ratio})
    table = pd.DataFrame(rows)
    if save_dir is not None and not table.empty:
        out = Path(save_dir) / filemgmt.file_title(
            "Song Characteristics Lookup Table", ".csv")
        table.to_csv(out, index=False)
        print(f"Saved lookup table -> {out}")
    return table


def extend_lookup_table(result_dir: Path,
                        audio_config_path: Path | None = None,
                        single_files_to_add: list[tuple] | None = None,
                        audio_dir: Path | None = None,
                        duration: float = 120.0,
                        device=None) -> pd.DataFrame:
    """Spotify-extension of the lookup table (reference :178-264).

    1. load the newest 'Song Characteristic Lookup Table';
    2. join Title/Artist/manual-BPM fetched through the Spotify controller
       (``add_metrics_from_txt`` with the music-selection config);
    3. append hand-specified single files, computing their audio features
       (entries: (file_title, artist, title, category, genre, spotify_url,
       start_after_sec));
    4. save the 'Extended Song Characteristic Lookup Table'.
    """
    result_dir = Path(result_dir)
    path = filemgmt.most_recent_file(
        result_dir, ".csv", ["Song Characteristic", "Lookup Table"])
    frame = pd.read_csv(path)
    if "File Title" in frame.columns:
        frame = frame.set_index("File Title")
    drop = [c for c in frame.columns if "Unnamed" in c]
    frame = frame.drop(columns=drop)

    if audio_config_path is not None:
        frame = mc.add_metrics_from_txt(frame, audio_config_path)

    new_rows = []
    for entry in (single_files_to_add or []):
        (file_title, artist, title, category, genre, spotify_url,
         start_after) = entry
        bpm, flux, centroid, ioi_cv, sync_deg, sync_ratio = \
            mc.compute_all_musical_features(Path(audio_dir) / file_title,
                                            duration=duration,
                                            verbose=False, device=device)
        new_rows.append({
            "File Title": file_title, "Category": category,
            "Genre": genre, "Spotify URL": spotify_url,
            "Intended Start [sec]": start_after,
            "BPM": bpm, "BPM_manual": bpm,
            "Spectral Flux Min.": float(np.min(flux)),
            "Spectral Flux Max.": float(np.max(flux)),
            "Spectral Flux Mean": float(np.mean(flux)),
            "Spectral Flux Std.": float(np.std(flux)),
            "Spectral Centroid Min": float(np.min(centroid)),
            "Spectral Centroid Max": float(np.max(centroid)),
            "Spectral Centroid Mean": float(np.mean(centroid)),
            "IOI Variance Coeff": ioi_cv,
            "Syncopation Degree": sync_deg,
            "Syncopation Ratio": sync_ratio,
            "Title": title, "Artist": artist})
    if new_rows:
        add = pd.DataFrame(new_rows).set_index("File Title")
        frame = pd.concat([frame, add])

    out = result_dir / filemgmt.file_title(
        "Extended Song Characteristic Lookup Table", ".csv")
    frame.to_csv(out)
    print(f"Saved extended lookup table -> {out}")
    return frame


MUSIC_FEATURE_LABELS = [
    "BPM", "Spectral Flux Mean", "Spectral Flux Std.",
    "Spectral Centroid Mean", "IOI Variance Coeff",
    "Syncopation Degree", "Syncopation Ratio"]


def cluster_song_features(table: pd.DataFrame,
                          feature_labels: list[str] | None = None,
                          k: int = 4,
                          save_dir: Path | None = None,
                          random_state: int = 42) -> dict:
    """K-means clustering of standardised song features with a 2-D
    embedding scatter (reference :335-396).

    Documented substitution: the reference embeds with UMAP; umap-learn is
    not installable in this environment, so the embedding falls back to
    PCA (umap is used when importable — same plot contract either way).
    """
    from sklearn.cluster import KMeans
    from sklearn.preprocessing import StandardScaler

    from mba_tpu_torch.pipeline.visualizations import _pyplot, smart_save_fig
    plt = _pyplot()

    feature_labels = feature_labels or [
        c for c in MUSIC_FEATURE_LABELS if c in table.columns]
    X = table[feature_labels].to_numpy(float)
    ok = np.isfinite(X).all(axis=1)
    X = X[ok]
    if X.shape[0] < k:
        raise ValueError(f"need at least k={k} complete songs, "
                         f"got {X.shape[0]}")
    Xs = StandardScaler().fit_transform(X)
    km = KMeans(n_clusters=k, random_state=random_state, n_init=10)
    labels = km.fit_predict(Xs)

    try:                                     # pragma: no cover - not in env
        import umap
        reducer = umap.UMAP(n_components=2, random_state=random_state)
        emb = reducer.fit_transform(Xs)
        cent = reducer.transform(km.cluster_centers_)
        axis_name = "UMAP"
    except ImportError:
        from sklearn.decomposition import PCA
        reducer = PCA(n_components=2, random_state=random_state)
        emb = reducer.fit_transform(Xs)
        cent = reducer.transform(km.cluster_centers_)
        axis_name = "PCA"

    fig, ax = plt.subplots(figsize=(6, 6))
    sc = ax.scatter(emb[:, 0], emb[:, 1], c=labels, cmap="Set1", s=15)
    ax.scatter(cent[:, 0], cent[:, 1], c="black", marker="x", s=150,
               linewidths=3, label="Centroids")
    handles, lab_vals = sc.legend_elements()
    ax.legend(handles + [ax.collections[-1]],
              [f"Cluster {v}" for v in range(k)] + ["Centroids"],
              fontsize=7)
    ax.set_xlabel(f"{axis_name} 1")
    ax.set_ylabel(f"{axis_name} 2")
    ax.set_title(f"K-Means {axis_name} Visualization")
    if save_dir is not None:
        smart_save_fig(save_dir, f"Song Feature Clusters {axis_name}",
                       fig=fig)
    plt.close(fig)
    return {"labels": labels, "centroids": km.cluster_centers_,
            "embedding": emb, "embedding_method": axis_name,
            "feature_labels": feature_labels, "figure": fig}


def music_feature_mi_and_scatters(table: pd.DataFrame,
                                  target_column: str = "Category",
                                  feature_labels: list[str] | None = None,
                                  scatter_x_y_combinations=(
                                      ("BPM", "Syncopation Degree"),
                                      ("Spectral Flux Mean",
                                       "Spectral Centroid Mean")),
                                  save_dir: Path | None = None) -> dict:
    """MI importance of the musical features for the category/genre label
    + per-pair scatter/KDE plots (reference :398-431).  The familiarity
    prefix is stripped from categories exactly as the reference does."""
    from mba_tpu_torch.pipeline.signal_features import (
        compute_feature_mi_importance)
    from mba_tpu_torch.pipeline.visualizations import plot_scatter

    feature_labels = feature_labels or [
        c for c in MUSIC_FEATURE_LABELS if c in table.columns]
    sub = table.dropna(subset=feature_labels + [target_column])
    target = [str(c).replace("Unfamiliar ", "").replace("Familiar ", "")
              for c in sub[target_column]]
    X = sub[feature_labels].to_numpy(float)
    res = compute_feature_mi_importance(
        X, target, feature_labels, target_column,
        include_barplot=save_dir is not None, plot_save_dir=save_dir)
    importance = res[-1] if isinstance(res, tuple) else res
    for x_lab, y_lab in scatter_x_y_combinations:
        if x_lab not in feature_labels or y_lab not in feature_labels:
            continue
        plot_scatter(sub[x_lab], sub[y_lab], x_label=x_lab,
                     y_label=y_lab, category_list=target,
                     category_label=target_column, save_dir=save_dir)
    return importance


def analyse_category_reassignments(stats_frame: pd.DataFrame,
                                   save_dir: Path | None = None):
    """Intended vs perceived category flow (reference :268-328)."""
    from mba_tpu_torch.pipeline.visualizations import plot_category_sankey
    sub = stats_frame.dropna(subset=["Perceived Category"])
    sub = sub[sub["Category or Silence"] != "Silence"]
    if sub.empty:
        return None
    return plot_category_sankey(
        sub["Category or Silence"].tolist(),
        sub["Perceived Category"].tolist(),
        title="Intended vs Perceived Category", save_dir=save_dir)


if __name__ == "__main__":
    from mba_tpu_torch.workflows.paths import StudyPaths

    # module-level flags (reference style, :19-45)
    extend_lookup_table_from_config = False
    cluster_results = True
    compute_mutual_information = True
    single_files_to_add: list[tuple] = []

    paths = StudyPaths().ensure()
    audio_dir = paths.data / "audio"
    table = None
    if audio_dir.exists():
        table = build_song_characteristics_table(
            audio_dir, save_dir=paths.song_characteristics)
    if extend_lookup_table_from_config:
        table = extend_lookup_table(
            paths.song_characteristics,
            audio_config_path=paths.root / "config"
            / "music_selection.txt",
            single_files_to_add=single_files_to_add,
            audio_dir=audio_dir)
    if table is not None and not table.empty:
        if cluster_results and len(table) >= 4:
            cluster_song_features(table, k=min(4, len(table)),
                                  save_dir=paths.song_characteristics)
        if compute_mutual_information and "Category" in table.columns:
            music_feature_mi_and_scatters(
                table, save_dir=paths.song_characteristics)
