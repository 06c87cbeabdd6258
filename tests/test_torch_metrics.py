"""The port's numpy metrics against the JAX package's scikit-learn ones on
the same numpy inputs (integers equal, floats within 1e-12), under
hypothesis: binary tasks, multiclass tasks with absent classes, all
Unknown, tied scores and a single class present.  Also the host
space-to-depth pack, bit for bit against the JAX package's."""

import csv
import os
import tempfile

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import wadt  # noqa: F401
from wadt.ops import preprocess as jpre
from wadt.utils import metrics as jmetrics

from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.ops import (
    preprocess as tpre,
)
from heuristic_style_transfer_for_real_time_efficient_weather_attribute_detection_tpu_torch.utils import (
    metrics as tmetrics,
)

TOL = 1e-12
SETTINGS = settings(max_examples=30, deadline=None, derandomize=True,
                    suppress_health_check=[HealthCheck.too_slow])


def assert_same(want, got, path=""):
    """Equal structure and integers, floats within TOL, None where None."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (path, want, got)
        for k in want:
            assert_same(want[k], got[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, want, got)
        for i, (a, b) in enumerate(zip(want, got)):
            assert_same(a, b, f"{path}[{i}]")
    elif isinstance(want, (float, np.floating)):
        assert isinstance(got, float), (path, want, got)
        assert abs(want - got) <= TOL, (path, want, got)
    else:
        assert type(got) is type(want) and got == want, (path, want, got)


@st.composite
def task_case(draw):
    """One task's (k, labels, preds, probs): labels may hold IGNORE_INDEX
    and leave classes out, preds may hold UNKNOWN_PRED, and probabilities
    are drawn from a few levels so that scores tie."""
    k = draw(st.integers(2, 5))
    n = draw(st.integers(0, 24))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.RandomState(seed)
    present = rng.choice(k, size=draw(st.integers(1, k)), replace=False)
    labels = rng.choice(present, size=n).astype(np.int64)
    labels[rng.rand(n) < draw(st.sampled_from([0.0, 0.2]))] = -100
    unknown = draw(st.sampled_from([0.0, 0.3, 1.0]))  # 1.0: every prediction Unknown
    preds = rng.randint(0, k, n).astype(np.int64)
    preds[rng.rand(n) < unknown] = -1
    levels = draw(st.sampled_from([3, 50]))  # few levels: tied scores
    probs = rng.randint(1, levels, (n, k)).astype(np.float64)
    probs /= probs.sum(axis=1, keepdims=True)
    return k, labels, preds, probs


@SETTINGS
@given(task_case())
def test_task_metrics_match_sklearn(case):
    k, labels, preds, probs = case
    names = [f"c{i}" for i in range(k)]
    keep = labels != -100  # task_metrics_and_roc takes the labeled samples
    args = ("T", names, preds[keep], labels[keep], probs[keep])
    assert_same(jmetrics.task_metrics_and_roc(*args), tmetrics.task_metrics_and_roc(*args))
    # the ROC step alone, also on samples with IGNORE labels
    rargs = ("T", names, labels, probs, None)
    assert_same(jmetrics._roc_analysis(*rargs), tmetrics._roc_analysis(*rargs))
    if keep.sum():
        from sklearn.metrics import confusion_matrix

        valid = preds[keep] != -1
        want = (confusion_matrix(labels[keep][valid], preds[keep][valid], labels=list(range(k))).tolist()
                if valid.sum() else np.zeros((k, k)).tolist())
        assert tmetrics.family_confusion(preds[keep], labels[keep], k) == want


@pytest.mark.parametrize("case", ["binary", "multiclass_absent", "tied", "single_class"])
def test_roc_artifacts_match_sklearn(case, tmp_path):
    """The ROC CSV rows and the figure, per case, against the JAX package's."""
    rng = np.random.RandomState(0)
    k = 2 if case == "binary" else 4
    labels = {"binary": rng.randint(0, 2, 30), "multiclass_absent": rng.choice([0, 2, 3], 30),
              "tied": rng.randint(0, 4, 30), "single_class": np.full(30, 1)}[case]
    probs = rng.rand(30, k)
    if case == "tied":
        probs = np.round(probs, 1)
    probs /= probs.sum(axis=1, keepdims=True)
    names = [f"c{i}" for i in range(k)]
    want = jmetrics._roc_analysis("T", names, labels, probs, str(tmp_path / "j"))
    got = tmetrics._roc_analysis("T", names, labels, probs, str(tmp_path / "t"))
    assert_same(want[:3], got[:3])
    assert (want[3] is None) == (got[3] is None) == (case == "single_class")
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    rows = [list(csv.reader(open(tmp_path / d / "T_roc_data.csv"))) for d in ("j", "t")]
    assert len(rows[0]) == len(rows[1])
    for w, g in zip(*rows):
        assert w[:2] == g[:2]
        if w[0] != "curve_type":
            np.testing.assert_allclose(np.float64(g[2:]), np.float64(w[2:]), atol=TOL, rtol=0)


@st.composite
def label_pairs(draw):
    """(y_true, y_pred, labels): ints or strings, predictions that may use
    classes the truth never does, and an explicit label subset or None."""
    n = draw(st.integers(1, 30))
    k = draw(st.integers(1, 6))
    rng = np.random.RandomState(draw(st.integers(0, 2 ** 31 - 1)))
    y_true, y_pred = rng.randint(0, k, n), rng.randint(0, k + 1, n)
    if draw(st.booleans()):
        names = np.array(["Clear", "Fog", "Rain", "Snow", "Sun", "Hail", "Dust"])
        y_true, y_pred = list(names[y_true]), list(names[y_pred])
    labels = None
    if draw(st.booleans()):
        labels = sorted(set(y_true))
    return y_true, y_pred, labels


@SETTINGS
@given(label_pairs())
def test_precision_recall_f1_match_sklearn(case):
    from sklearn.metrics import f1_score, precision_score, recall_score

    y_true, y_pred, labels = case
    for average in ("weighted", "macro", None):
        got = tmetrics.precision_recall_fscore(y_true, y_pred, labels=labels, average=average)
        for fn, g in zip((precision_score, recall_score, f1_score), got):
            want = fn(y_true, y_pred, labels=labels, average=average, zero_division=0)
            np.testing.assert_allclose(g, want, atol=TOL, rtol=0)
            if average is not None:
                assert isinstance(g, float)


@SETTINGS
@given(st.integers(0, 2 ** 31 - 1), st.integers(2, 40), st.sampled_from([2, 10, 1000]))
def test_roc_curve_auc_match_sklearn(seed, n, levels):
    from sklearn.metrics import auc, roc_auc_score, roc_curve

    rng = np.random.RandomState(seed)
    y = rng.randint(0, 2, n)
    score = rng.randint(0, levels, n) / levels
    if len(np.unique(y)) < 2:
        assert tmetrics.roc_auc_score(y, score) is None  # the reference's "undefined"
        return
    want = roc_curve(y, score)
    got = tmetrics.roc_curve(y, score)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
    assert abs(tmetrics.auc(got[0], got[1]) - auc(want[0], want[1])) <= TOL
    assert abs(tmetrics.roc_auc_score(y, score) - roc_auc_score(y, score)) <= TOL


def test_auc_direction_check():
    assert tmetrics.auc([1.0, 0.5, 0.0], [1.0, 1.0, 0.0]) == 0.75
    with pytest.raises(ValueError, match="neither increasing nor decreasing"):
        tmetrics.auc([0.0, 1.0, 0.5], [0.0, 1.0, 1.0])


def test_metrics_summary_csv_matches_jax():
    rng = np.random.RandomState(3)
    metrics = {}
    for t in ("A", "B"):
        labels = rng.randint(0, 3, 20)
        probs = rng.rand(20, 3)
        probs /= probs.sum(axis=1, keepdims=True)
        metrics[t] = tmetrics.task_metrics_and_roc(t, ["x", "y", "z"], probs.argmax(1), labels, probs)
    with tempfile.TemporaryDirectory() as d:
        paths = [os.path.join(d, n) for n in ("j.csv", "t.csv")]
        jmetrics.write_metrics_summary_csv(paths[0], metrics)
        tmetrics.write_metrics_summary_csv(paths[1], metrics)
        assert open(paths[0]).read() == open(paths[1]).read()


@pytest.mark.parametrize("shape,k", [((2, 224, 224, 3), 4), ((3, 30, 22, 3), 4), ((1, 9, 9, 2), 3)])
def test_s2d_pack_matches_jax(shape, k):
    """The numpy pack equals the JAX package's (its C kernel where it
    builds, numpy otherwise) bit for bit, crop included; unpack inverts it."""
    u8 = np.random.RandomState(0).randint(0, 256, shape, np.uint8)
    got = tpre.s2d_pack_uint8(u8, k)
    np.testing.assert_array_equal(got, jpre.s2d_pack_uint8(u8, k))
    assert got.flags.c_contiguous and got.dtype == np.uint8
    back = tpre.s2d_unpack_uint8(got, k)
    np.testing.assert_array_equal(back, jpre.s2d_unpack_uint8(got, k))
    h, w = shape[1] // k * k, shape[2] // k * k
    np.testing.assert_array_equal(back, u8[:, :h, :w])


def test_host_normalize_matches_jax(tmp_path):
    from PIL import Image

    u8 = np.random.RandomState(1).randint(0, 256, (2, 5, 7, 3), np.uint8)
    np.testing.assert_array_equal(tpre.normalize_uint8_host(u8), jpre.normalize_uint8_host(u8))
    Image.fromarray(u8[0]).save(tmp_path / "a.png")
    np.testing.assert_array_equal(tpre.load_image_normalized(str(tmp_path / "a.png")),
                                  jpre.load_image_normalized(str(tmp_path / "a.png")))
    for name in (".jpg", "a.JPEG", "b.png", "c.txt", "d.bmp", "e"):
        assert tpre.is_image_name(name) == jpre.is_image_name(name)
    assert tpre.VALID_EXTS == jpre.VALID_EXTS
