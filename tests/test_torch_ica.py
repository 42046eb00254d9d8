"""Parity of ``mba_tpu_torch.ops.ica`` (extended-Infomax ICA, IC labels)
with ``mba_tpu.ops.ica`` on the CPU.

The port draws the JAX package's block shifts (threefry, ``ops/prng.py``),
so both run the same epochs on the same data.  Tolerances: W after three
epochs within rtol 1e-4 (atol 1e-6·max|W| for entries near zero; float32
matmuls summed in another order); a converged fit's sources equal up to
sign and order at |corr| ≥ 0.999; ``apply`` and ``label_components`` on
one fit carried across by ``convert.ica_from_jax``: labels equal, output
within 1e-4·max|x|.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mba_tpu.ops import ica as JI

from mba_tpu_torch import convert
from mba_tpu_torch.ops import ica as TI
from mba_tpu_torch.ops import prng

from test_ic_classify import CH_NAMES, FS as IC_FS, build_components

torch.set_num_threads(1)

CORR_MIN = 0.999


def _mixed_sources(fs=256, seconds=30, seed=0, n_ch=5):
    """tests/test_ops_ica.py's mixture: a square wave, a sine and a
    Laplacian source under 2 % sensor noise."""
    rng = np.random.default_rng(seed)
    n = fs * seconds
    t = np.arange(n) / fs
    sources = np.stack([np.sign(np.sin(2 * np.pi * 0.7 * t)),
                        np.sin(2 * np.pi * 11 * t + 1.0),
                        rng.laplace(size=n)], axis=1)
    sources /= sources.std(axis=0)
    mixing = rng.standard_normal((n_ch, 3))
    return sources @ mixing.T + 0.02 * rng.standard_normal((n, n_ch))


def _artifact_recording(seed=11):
    """ECG and blink components among five brain ones, 16 channels, 90 s
    at 256 Hz (tests/test_ic_classify.py's generators)."""
    rng = np.random.default_rng(seed)
    sources, mixing, _ = build_components(rng, ["ecg", "blink"])
    data = sources @ mixing.T
    return data + 0.05 * rng.standard_normal(data.shape)


def _matched_corr(a, b):
    """|corr| of each column of ``a`` with its best match in ``b``, and
    that match's index."""
    k = a.shape[1]
    c = np.abs(np.corrcoef(a.T, b.T)[:k, k:])
    return c.max(axis=1), c.argmax(axis=1)


def _whitened(x, ica):
    return ((x - x.mean(0)) @ ica._whitener.T).astype(np.float32)


@pytest.mark.parametrize("seed,block", [(42, 80), (7, 33)])
def test_three_epochs_match_jax(seed, block):
    """The same key, data and learning rate: the same three shifts, so W
    agrees after three epochs."""
    x = _mixed_sources()
    xw = _whitened(x, JI.InfomaxICA(3, max_iter=1).fit(x))
    wj, nj = JI._extended_infomax(jax.random.PRNGKey(seed), jnp.asarray(xw),
                                  3, block, 3, np.float32(0.003))
    wt, nt = TI._extended_infomax(prng.prng_key(seed), torch.from_numpy(xw),
                                  3, block, 3, np.float32(0.003))
    wj = np.asarray(wj)
    assert int(nj) == nt == 3
    np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-4,
                               atol=1e-6 * np.abs(wj).max())


def test_shift_sequence_is_jax_randint():
    """The epochs' shifts: ``key, sub = split(key)``, then
    ``randint(sub, (), 0, n_blocks)``."""
    key_j, key_t = jax.random.PRNGKey(42), prng.prng_key(42)
    for _ in range(5):
        key_j, sub_j = jax.random.split(key_j)
        key_t, sub_t = prng.split(key_t)
        assert int(jax.random.randint(sub_j, (), 0, 97)) == int(
            prng.randint(sub_t, (), 0, 97))


@pytest.mark.parametrize("data,n_comp", [("mixed", 3), ("artifacts", 7)])
def test_converged_fit_matches_jax(data, n_comp):
    x = _mixed_sources() if data == "mixed" else _artifact_recording()
    ref = JI.InfomaxICA(n_components=n_comp, max_iter=400).fit(x)
    got = TI.InfomaxICA(n_components=n_comp, max_iter=400,
                        device="cpu").fit(x)
    assert got.n_components_ == ref.n_components_ == n_comp
    assert got.block_ == ref.block_
    assert got.n_iter_ < 400 and ref.n_iter_ < 400
    assert got.timings_["epochs"] == got.n_iter_
    src_t, src_j = got.get_sources(x), ref.get_sources(x)
    assert src_t.dtype == np.float64 and src_t.shape == (len(x), n_comp)
    best, match = _matched_corr(src_t, src_j)
    assert best.min() >= CORR_MIN, best
    assert sorted(match) == list(range(n_comp))
    np.testing.assert_allclose(got._mean, ref._mean, rtol=1e-5,
                               atol=1e-7 * np.abs(x).max())


def test_rank_deficient_data_caps_like_jax():
    """Five channels carrying three sources and no noise: the rank cap
    keeps three components in both packages."""
    rng = np.random.default_rng(2)
    x = _mixed_sources(seconds=10)[:, :3] @ rng.standard_normal((3, 5))
    ref = JI.InfomaxICA(n_components=5, max_iter=50).fit(x)
    got = TI.InfomaxICA(n_components=5, max_iter=50, device="cpu").fit(x)
    assert got.n_components_ == ref.n_components_ == 3


def _carried(ref, device="cpu"):
    return convert.ica_from_jax(ref._mean, ref._whitener, ref.unmixing_,
                                ref.mixing_, ref.n_components_, ref.n_iter_,
                                ref.exclude, device=device)


@pytest.mark.parametrize("as_tensor", [False, True])
def test_labels_and_apply_on_one_fit(as_tensor):
    """One JAX fit carried into the port: labels equal on the host path
    (numpy) and the device path (a tensor: the 120-s segment and the
    moments), the cleaned recording within 1e-4·max|x|."""
    x = _artifact_recording()
    ref = JI.InfomaxICA(n_components=7, random_state=42).fit(x)
    got = _carried(ref)
    inp = torch.as_tensor(x, dtype=torch.float32) if as_tensor else x
    lab_t = TI.label_components(got, inp, IC_FS, CH_NAMES)
    lab_j = JI.label_components(
        ref, jnp.asarray(x, jnp.float32) if as_tensor else x, IC_FS,
        CH_NAMES)
    assert lab_t["labels"] == lab_j["labels"]
    assert "heart beat" in lab_t["labels"]
    np.testing.assert_allclose(lab_t["y_pred_proba"], lab_j["y_pred_proba"],
                               rtol=1e-3, atol=1e-4)
    exclude = [i for i, lab in enumerate(lab_t["labels"])
               if lab in ("heart beat", "eye blink")]
    out_t = got.apply(inp, exclude=exclude)
    out_j = ref.apply(jnp.asarray(x, jnp.float32) if as_tensor else x,
                      exclude=exclude)
    if as_tensor:
        assert isinstance(out_t, torch.Tensor) and out_t.dtype == torch.float32
    else:
        assert isinstance(out_t, np.ndarray) and out_t.dtype == np.float64
    np.testing.assert_allclose(np.asarray(out_t), np.asarray(out_j), rtol=0,
                               atol=1e-4 * np.abs(x).max())


def test_apply_without_exclusion_returns_the_input():
    x = _mixed_sources(seconds=10)
    ica = _carried(JI.InfomaxICA(3, max_iter=20).fit(x))
    out = ica.apply(x, exclude=[])
    assert out is not x and np.array_equal(out, x)
    t = torch.as_tensor(x, dtype=torch.float32)
    assert ica.apply(t, exclude=[]) is t
    ica.exclude = [1]
    assert not np.allclose(ica.apply(x), x)


def test_source_moments_match_jax():
    src = _mixed_sources(seconds=5).astype(np.float32)
    for a, b in zip(TI._source_moments(torch.from_numpy(src)),
                    JI._source_moments(jnp.asarray(src))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_ica_from_jax_checks_shapes():
    x = _mixed_sources(seconds=5)
    ref = JI.InfomaxICA(3, max_iter=5).fit(x)
    with pytest.raises(ValueError, match="inconsistent"):
        convert.ica_from_jax(ref._mean, ref._whitener, ref.unmixing_,
                             ref.mixing_.T, 3, 5)


@pytest.mark.parametrize("seed,block", [(42, 80), (7, 33)])
def test_reference_layout_three_epochs_match_jax(seed, block):
    """``batch_layout='reference'``: each epoch's blocks are
    ``x_white[permutation(sub, n_blocks·block)]``, the permutation bit for
    bit JAX's (``tests/test_torch_prng.py``), so W agrees after three
    epochs at ``test_three_epochs_match_jax``'s tolerances."""
    x = _mixed_sources()
    xw = _whitened(x, JI.InfomaxICA(3, max_iter=1).fit(x))
    wj, nj = JI._extended_infomax(jax.random.PRNGKey(seed), jnp.asarray(xw),
                                  3, block, 3, np.float32(0.003),
                                  batch_layout="reference")
    wt, nt = TI._extended_infomax(prng.prng_key(seed), torch.from_numpy(xw),
                                  3, block, 3, np.float32(0.003),
                                  batch_layout="reference")
    wj = np.asarray(wj)
    assert int(nj) == nt == 3
    np.testing.assert_allclose(wt.numpy(), wj, rtol=1e-4,
                               atol=1e-6 * np.abs(wj).max())


def test_reference_layout_fit_matches_jax():
    """A converged fit in the reference layout: the sources of the port
    and the JAX package match up to sign and order."""
    x = _mixed_sources()
    ref = JI.InfomaxICA(3, max_iter=400, batch_layout="reference").fit(x)
    got = TI.InfomaxICA(3, max_iter=400, batch_layout="reference",
                        device="cpu").fit(x)
    assert got.n_iter_ < 400 and ref.n_iter_ < 400
    best, match = _matched_corr(got.get_sources(x), ref.get_sources(x))
    assert best.min() >= CORR_MIN, best
    assert sorted(match) == list(range(3))
    with pytest.raises(ValueError):
        TI.InfomaxICA(3, batch_layout="shuffled", device="cpu")


def test_fit_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        TI.InfomaxICA(3, max_iter=5).fit(_mixed_sources(seconds=5))
