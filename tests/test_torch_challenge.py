"""The port's jax-free copy of the challenge corpora (kss_icp_torch/challenge.py)
produces the JAX package's arrays (kss_icp_tpu/challenge.py, stress.rot_xyz)
bit for bit, at reduced point counts, and the same pose error."""

import numpy as np
import pytest

from kss_icp_torch import challenge as tch
from kss_icp_tpu import challenge as jch
from kss_icp_tpu.stress import rot_xyz


@pytest.mark.parametrize("corpus, kw", [
    ("category_corpus", dict(instances=6, n_points=300)),  # instances past 5 take the later perturbations
    ("partial_corpus", dict(n_points=300)),
    ("partial_corpus", dict(n_points=300, keep=0.8)),  # the hard tier
    ("deform_corpus", dict(n_points=300)),
    ("scale_corpus", dict(n_points=300)),
])
def test_corpus_equals_jax(corpus, kw):
    got, want = getattr(tch, corpus)(**kw), getattr(jch, corpus)(**kw)
    assert [p[0] for p in got] == [p[0] for p in want]
    for (_, s1, t1, g1), (_, s2, t2, g2) in zip(got, want):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(t1, t2)
        assert s1.dtype == np.float32 and t1.dtype == np.float32
        for k in ("R", "s", "t"):
            np.testing.assert_array_equal(g1[k], g2[k])


def test_rot_xyz_and_transform_rmse_equal_jax(rng):
    np.testing.assert_array_equal(tch.rot_xyz(0.3, -1.2, 2.5), rot_xyz(0.3, -1.2, 2.5))
    name, src, tgt, gt = tch.category_corpus(instances=1, n_points=200)[0]
    moved = tch.truth_aligned(src, gt) + rng.normal(0, 0.01, size=src.shape)
    assert tch.transform_rmse(moved, src, gt) == jch.transform_rmse(moved, src, gt)


def test_boards_match_the_jax_registry():
    want = [(name, thr) for name, _, thr in jch.challenge_corpus(include_hard=True)]
    assert [(b, thr) for b, _, thr in tch.BOARDS] == want
    assert [getattr(fn, "func", fn).__name__ for _, fn, _ in tch.BOARDS] == [
        "category_corpus", "partial_corpus", "deform_corpus", "scale_corpus", "partial_corpus"]
    assert tch.BOARDS[-1][1].keywords == {"keep": 0.8}
    assert [b for b, _, _ in tch.challenge_corpus()] == [b for b, _, _ in jch.challenge_corpus()]
