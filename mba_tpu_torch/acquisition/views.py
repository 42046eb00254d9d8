"""Interactive experiment views (matplotlib) with headless analogues (a
host copy of ``mba_tpu/acquisition/views.py`` that imports matplotlib
only where a view is built: the card machine has none).

Parity target: reference ``src/pipeline/measurements_and_interactive_
visuals.py`` — ``AnimationManager`` (:457-495), questionnaire forms
(onboarding :750-933, offboarding :936-1017, familiarity :1274-1335,
post-trial rating :1339-1448, breakout countdown :1225-1271),
``plot_input_view`` live rolling plot + polar gauge + sine force target +
corridor + accuracy feed (:1451-1779), ``qtc_control_master_view`` master
GUI (:1843-2183) and ``plot_performance_view`` cross-subject RMSE
boxplots (:2186-2287).

Every view here runs in two modes:

* ``interactive=True`` — real matplotlib widgets/animation, blocking,
  for use on a workstation during acquisition.
* ``interactive=False`` — the same figure and widget wiring is built
  and driven programmatically (N frames rendered / prefill applied /
  buttons pressed through the returned handles), so the views are fully
  exercisable headless (Agg backend) and in CI.  This replaces the
  reference's display-bound code paths, which cannot run in this repo's
  TPU build environment.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import pandas as pd

from mba_tpu_torch.acquisition.sampling import dynamometer_volt_to_force
from mba_tpu_torch.utils import file_management as filemgmt


def _pyplot():
    """matplotlib's pyplot, imported when a view is built.  The backend is
    left as configured, so that an interactive view can open a window."""
    import matplotlib.pyplot as plt
    return plt


# ─────────────────────────────── animation ───────────────────────────────
class AnimationManager:
    """Owns a FuncAnimation and guarantees a safe shutdown (reference
    :457-495): the update callback checks ``stop_event`` every frame and
    stops the event source + closes the figure instead of raising out of
    a dead Tk/Qt mainloop."""

    def __init__(self, fig, update_fn, stop_event=None,
                 interval_ms: float = 33.0):
        self.fig = fig
        self.stop_event = stop_event
        self._user_update = update_fn
        self._frame_count = 0
        self._interval_ms = interval_ms
        # built lazily in show(): a live FuncAnimation hooks the canvas
        # draw event and would fire extra frames during headless step()
        self.animation = None

    def _update(self, frame):
        if self.stop_event is not None and self.stop_event.is_set():
            self.stop()
            return []
        self._frame_count += 1
        return self._user_update(frame) or []

    def step(self, n: int = 1):
        """Headless: drive the update callback directly (no mainloop)."""
        artists = []
        for i in range(n):
            artists = self._update(self._frame_count)
        self.fig.canvas.draw_idle()
        return artists

    def stop(self):
        if self.animation is not None:
            try:
                self.animation.event_source.stop()
            except AttributeError:
                pass
        _pyplot().close(self.fig)

    def show(self):                # pragma: no cover - needs a display
        from matplotlib.animation import FuncAnimation
        self.animation = FuncAnimation(self.fig, self._update,
                                       interval=self._interval_ms,
                                       cache_frame_data=False)
        _pyplot().show()


# ───────────────────────── questionnaire forms ──────────────────────────
_LISTENING_CHOICES = ["Rarely", "A small part of the day",
                      "A considerable part of the day",
                      "Most of the day"]


@dataclass
class _Form:
    """A matplotlib-widgets form: labelled fields → dict on submit."""
    title: str
    fields: list  # (key, kind, default, choices)
    result: dict = field(default_factory=dict)

    def build(self):
        from matplotlib import widgets as w
        n = len(self.fields)
        fig = _pyplot().figure(figsize=(6, 1.2 + 0.9 * n))
        fig.suptitle(self.title)
        self._widgets = {}
        for i, (key, kind, default, choices) in enumerate(self.fields):
            ax = fig.add_axes([0.45, 1 - (i + 1.2) / (n + 2), 0.45,
                               0.7 / (n + 2)])
            if kind == "text":
                self._widgets[key] = w.TextBox(ax, key + "  ",
                                             initial=str(default))
            elif kind == "radio":
                self._widgets[key] = w.RadioButtons(
                    ax, choices, active=choices.index(default))
                ax.set_title(key, fontsize=8, loc="left")
            elif kind == "slider":
                lo, hi = choices
                self._widgets[key] = w.Slider(ax, key + "  ", lo, hi,
                                            valinit=default, valstep=1)
        ax_btn = fig.add_axes([0.45, 0.02, 0.2, 0.6 / (n + 2)])
        self._btn = w.Button(ax_btn, "Submit")
        self._btn.on_clicked(lambda _ev: self.submit())
        self.fig = fig
        return self

    def submit(self) -> dict:
        for key, kind, default, choices in self.fields:
            w = self._widgets[key]
            if kind == "text":
                self.result[key] = w.text
            elif kind == "radio":
                self.result[key] = w.value_selected
            elif kind == "slider":
                self.result[key] = int(w.val)
        _pyplot().close(self.fig)
        return self.result

    def run(self, interactive: bool, prefill: dict | None = None) -> dict:
        self.build()
        if prefill:
            for key, val in prefill.items():
                kinds = {k: (kind, choices) for k, kind, _d, choices
                         in self.fields}
                kind, choices = kinds[key]
                w = self._widgets[key]
                if kind == "text":
                    w.set_val(str(val))
                elif kind == "radio":
                    w.set_active(choices.index(val))
                elif kind == "slider":
                    w.set_val(val)
        if interactive:            # pragma: no cover - needs a display
            _pyplot().show()
            return self.result
        return self.submit()


def onboarding_form(interactive: bool = False,
                    prefill: dict | None = None) -> dict:
    """Subject-data form (reference :750-933)."""
    return _Form("Onboarding", [
        ("Name", "text", "Anonymous", None),
        ("Birthdate", "text", "2000-01-01", None),
        ("Gender", "radio", "diverse", ["female", "male", "diverse"]),
        ("Dominant hand", "radio", "Right", ["Right", "Left"]),
        ("Listening habit", "radio", _LISTENING_CHOICES[1],
         _LISTENING_CHOICES),
        ("Dancing habit", "slider", 1, (0, 7)),
        ("Athleticism", "slider", 2, (0, 7)),
        ("Musical skill", "slider", 2, (0, 7)),
    ]).run(interactive, prefill)


def offboarding_form(interactive: bool = False,
                     prefill: dict | None = None) -> dict:
    """Post-study feedback form (reference :936-1017)."""
    return _Form("Offboarding", [
        ("Total fatigue", "slider", 2, (0, 7)),
        ("Total pleasure", "slider", 3, (0, 7)),
    ]).run(interactive, prefill)


def legacy_plot_onboarding_form(result_json_dir=None,
                                shared_questionnaire_str=None,
                                interactive: bool = False,
                                prefill: dict | None = None,
                                **_legacy_kwargs) -> dict:
    """Back-compat alias for the reference's legacy onboarding entry
    point (measurements_and_interactive_visuals.py:1020-1117).

    Documented deviation: the reference's legacy variant hard-codes the
    one study's health-screening question strings and writes the result
    JSON itself; here those strings are presentation data, the modern
    :func:`onboarding_form` collects the same subject fields, and the
    caller persists the dict (the experiment workflow already does).
    Extra legacy keyword arguments are accepted and ignored.
    """
    del result_json_dir, shared_questionnaire_str, _legacy_kwargs
    return onboarding_form(interactive=interactive, prefill=prefill)


def familiarity_form(song_info: str, interactive: bool = False,
                     prefill: dict | None = None) -> dict:
    """Familiarity check for the song now playing (reference :1274-1335)."""
    return _Form(f"Familiarity — {song_info[:60]}", [
        ("Familiarity", "slider", 3, (0, 7)),
    ]).run(interactive, prefill)


def post_trial_rating_form(trial_label: str, interactive: bool = False,
                           prefill: dict | None = None) -> dict:
    """Post-trial rating form (reference :1339-1448)."""
    return _Form(f"Post-trial rating — {trial_label}", [
        ("Liking", "slider", 3, (0, 7)),
        ("Fitting Category", "slider", 3, (0, 7)),
        ("Emotional State", "slider", 3, (0, 7)),
    ]).run(interactive, prefill)


def breakout_countdown(seconds: float, interactive: bool = False,
                       tick_fn=None) -> int:
    """Between-trial countdown screen (reference :1225-1271).
    Returns the number of ticks displayed."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(4, 2))
    ax.axis("off")
    txt = ax.text(0.5, 0.5, "", ha="center", va="center", fontsize=28)
    n_ticks = max(int(np.ceil(seconds)), 1)
    for remaining in range(n_ticks, 0, -1):
        txt.set_text(f"Break: {remaining}s")
        fig.canvas.draw_idle()
        if tick_fn is not None:
            tick_fn(remaining)
        if interactive:            # pragma: no cover - needs a display
            plt.pause(min(1.0, seconds / n_ticks))
    plt.close(fig)
    return n_ticks


class FormController:
    """Drop-in ``controller`` for ``start_experiment_processes`` that
    routes every questionnaire through the matplotlib forms (the
    reference's GUI behaviour).  With ``interactive=False`` the forms
    auto-submit their defaults/prefills — byte-identical artefacts to
    ``_DefaultController``, but through the real widget code path."""

    def __init__(self, interactive: bool = False,
                 prefills: dict | None = None):
        self.interactive = interactive
        self.prefills = prefills or {}

    def onboarding(self) -> dict:
        return onboarding_form(self.interactive,
                               self.prefills.get("onboarding"))

    def offboarding(self) -> dict:
        return offboarding_form(self.interactive,
                                self.prefills.get("offboarding"))

    def familiarity(self, song_info: str) -> dict:
        return familiarity_form(song_info, self.interactive,
                                self.prefills.get("familiarity"))

    def post_trial_rating(self, trial_label: str) -> dict:
        return post_trial_rating_form(trial_label, self.interactive,
                                      self.prefills.get(
                                          "post_trial_rating"))


# ─────────────────────────── live input view ────────────────────────────
def plot_input_view(shared_dict, stop_event=None,
                    target_frequency_hz: float = 0.1,
                    min_pct_mvc: float = 7.5, max_pct_mvc: float = 22.5,
                    mvc_kg: float = 30.0, window_sec: float = 20.0,
                    refresh_hz: float = 30.0,
                    interactive: bool = False) -> AnimationManager:
    """Live force-task view (reference :1451-1779): rolling force trace
    against the sinusoidal target + corridor, a polar gauge of the
    instantaneous force, and the live accuracy feed.

    Reads ``fsr`` volts and ``accuracy`` from ``shared_dict`` (the same
    Manager dict the samplers publish to).  Returns the
    :class:`AnimationManager`; headless callers drive it with
    ``.step(n)``.
    """
    fig = _pyplot().figure(figsize=(10, 5))
    ax_trace = fig.add_subplot(1, 2, 1)
    ax_gauge = fig.add_subplot(1, 2, 2, projection="polar")

    n_pts = max(int(window_sec * refresh_hz), 2)
    t_axis = np.linspace(-window_sec, 0.0, n_pts)
    force_buf = np.full(n_pts, np.nan)

    mid = (min_pct_mvc + max_pct_mvc) / 2.0
    amp = (max_pct_mvc - min_pct_mvc) / 2.0
    t0 = time.monotonic()

    ax_trace.fill_between(t_axis, min_pct_mvc, max_pct_mvc,
                          color="tab:green", alpha=0.15,
                          label="target corridor")
    (target_line,) = ax_trace.plot(t_axis, np.zeros(n_pts), "k--",
                                   lw=1, label="target")
    (trace_line,) = ax_trace.plot(t_axis, force_buf, "tab:blue",
                                  lw=1.5, label="force")
    acc_text = ax_trace.text(0.02, 0.95, "", transform=ax_trace.transAxes,
                             fontsize=9, va="top")
    ax_trace.set_xlabel("time [s]")
    ax_trace.set_ylabel("force [% MVC]")
    ax_trace.set_ylim(0, max_pct_mvc * 2)
    ax_trace.legend(loc="upper right", fontsize=8)

    ax_gauge.set_theta_zero_location("W")
    ax_gauge.set_theta_direction(-1)
    ax_gauge.set_thetamin(0)
    ax_gauge.set_thetamax(180)
    ax_gauge.set_yticks([])
    full_scale = max_pct_mvc * 2
    needle, = ax_gauge.plot([0, 0], [0, 1], lw=3, color="tab:red")
    lo_th = np.pi * min_pct_mvc / full_scale
    hi_th = np.pi * max_pct_mvc / full_scale
    ax_gauge.fill_between(np.linspace(lo_th, hi_th, 32), 0, 1,
                          color="tab:green", alpha=0.25)
    ax_gauge.set_title("force gauge")

    def update(_frame):
        now = time.monotonic() - t0
        volts = shared_dict.get("fsr")
        pct = np.nan
        if volts is not None:
            pct = 100.0 * dynamometer_volt_to_force(float(volts)) \
                / max(mvc_kg, 1e-9)
        force_buf[:-1] = force_buf[1:]
        force_buf[-1] = pct
        trace_line.set_ydata(force_buf)
        phase = 2 * np.pi * target_frequency_hz * (now + t_axis)
        target_line.set_ydata(mid + amp * np.sin(phase))
        if np.isfinite(pct):
            theta = np.pi * np.clip(pct, 0, full_scale) / full_scale
            needle.set_data([theta, theta], [0, 1])
        acc = shared_dict.get("accuracy")
        acc_text.set_text("" if acc is None
                          else f"accuracy (sq.err): {acc:.3f}")
        return [trace_line, target_line, needle, acc_text]

    mgr = AnimationManager(fig, update, stop_event=stop_event,
                           interval_ms=1000.0 / refresh_hz)
    if interactive:                # pragma: no cover - needs a display
        mgr.show()
    return mgr


# ─────────────────────── master control view (QTC) ──────────────────────
class QtcControlMasterView:
    """Master control panel (reference ``qtc_control_master_view``
    :1843-2183): OTB trigger buttons, phase buttons, randomised music-
    category buttons, DC-offset slider, live log dict with
    WorkMem/interim saves.

    All controls act through ``press(name)`` / ``set_dc_offset(v)`` so a
    headless caller (or a test) exercises exactly the code the real
    button callbacks run.
    """

    def __init__(self, log, categories: list[str],
                 start_trigger_event=None, stop_trigger_event=None,
                 shared_dict=None, rng_seed: int = 0,
                 interactive: bool = False):
        self.log = log
        self.shared_dict = shared_dict if shared_dict is not None else {}
        self.start_trigger_event = start_trigger_event
        self.stop_trigger_event = stop_trigger_event
        rng = np.random.default_rng(rng_seed)
        self.category_order = list(rng.permutation(categories))
        self.dc_offset = 0.0
        self.pressed: list[str] = []
        self._build(interactive)
        if interactive:            # pragma: no cover - needs a display
            _pyplot().show()

    def _build(self, interactive: bool):
        names = (["Start Trigger", "Stop Trigger", "Interim Save",
                  "WorkMem Save"] + self.category_order)
        from matplotlib import widgets as w
        n = len(names)
        self.fig = _pyplot().figure(figsize=(4, 0.6 * n + 1.4))
        self.fig.suptitle("QTC control master")
        self._buttons = {}
        for i, name in enumerate(names):
            ax = self.fig.add_axes([0.15, 1 - (i + 1.4) / (n + 3), 0.7,
                                    0.7 / (n + 3)])
            btn = w.Button(ax, name)
            btn.on_clicked(lambda _ev, nm=name: self.press(nm))
            self._buttons[name] = btn
        ax_sl = self.fig.add_axes([0.15, 0.02, 0.7, 0.6 / (n + 3)])
        self._slider = w.Slider(ax_sl, "DC", -1.0, 1.0, valinit=0.0)
        self._slider.on_changed(self.set_dc_offset)

    def press(self, name: str) -> None:
        self.pressed.append(name)
        if name == "Start Trigger":
            if self.start_trigger_event is not None:
                self.start_trigger_event.set()
            self.log.append(event="Start Trigger")
        elif name == "Stop Trigger":
            if self.stop_trigger_event is not None:
                self.stop_trigger_event.set()
            self.log.append(event="Stop Trigger")
        elif name == "Interim Save":
            self.log.save_interim()
        elif name == "WorkMem Save":
            self.log.save_workmem()
        else:                       # a music-category button
            self.log.append(music=f"{name} requested")

    def set_dc_offset(self, value: float) -> None:
        self.dc_offset = float(value)
        self.shared_dict["dc_offset"] = self.dc_offset

    def close(self):
        _pyplot().close(self.fig)


def qtc_control_master_view(log, categories: list[str],
                            **kwargs) -> QtcControlMasterView:
    """Functional wrapper matching the reference's entry point."""
    return QtcControlMasterView(log, categories, **kwargs)


# ───────────────────────── performance view ─────────────────────────────
def plot_performance_view(experiment_data_dir: str | Path,
                          subjects: list[int] | None = None,
                          save_dir: str | Path | None = None,
                          show: bool = False):
    """Cross-subject RMSE boxplots (reference :2186-2287): loads every
    trial's ``Trial Accuracy Results`` CSV per subject and boxplots the
    per-trial RMSE distribution by subject."""
    root = Path(experiment_data_dir)
    if subjects is None:
        subjects = sorted(int(p.name.split("_")[1])
                          for p in root.glob("subject_*"))
    per_subject: dict[int, list[float]] = {}
    for subject in subjects:
        subj_dir = root / f"subject_{subject:02}"
        rmses = []
        for trial_dir in sorted(subj_dir.glob("song_*")) + \
                sorted(subj_dir.glob("silence_*")):
            try:
                path = filemgmt.most_recent_file(
                    trial_dir, ".csv", ["Trial Accuracy Results"])
            except ValueError:
                continue
            sq = pd.read_csv(path).iloc[:, -1]
            if len(sq):
                rmses.append(float(np.sqrt(np.mean(sq))))
        per_subject[subject] = rmses

    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(1.2 * max(len(per_subject), 2) + 2,
                                    4))
    labels = [f"S{s:02}" for s in per_subject]
    data = [v if v else [np.nan] for v in per_subject.values()]
    ax.boxplot(data, tick_labels=labels)
    ax.set_ylabel("trial RMSE [% MVC]")
    ax.set_title("Motor-task accuracy per subject")
    if save_dir is not None:
        from mba_tpu_torch.pipeline.visualizations import smart_save_fig
        # by keyword: the JAX package passes the figure third, where
        # smart_save_fig takes the suffix, and raises TypeError
        smart_save_fig(save_dir, "Performance View", fig=fig)
    if show:                       # pragma: no cover - needs a display
        plt.show()
    return fig, per_subject
