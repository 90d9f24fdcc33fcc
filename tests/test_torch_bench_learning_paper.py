"""The Sec 4.4.1 learning bench (``launch.bench_online_learning``) on the
CPU against the reference, on the paper topology (768:256:256:256:10, a
frozen packed prefix before the learned readout): at a cut batch (16
samples) its two planes learn the reference's bits and update counts, and
their rows carry the reference's hardware cost.  The readout topology and
the bench's other rows are held in ``test_torch_bench_learning.py``."""

from __future__ import annotations

import pytest
from torch_bench_rows import (LEARNING_TAGS, assert_learning_bits,
                              assert_learning_rows, assert_reference_rows,
                              learning_runs, one_torch_thread)  # noqa: F401

BATCH = 16
TAG = LEARNING_TAGS[1]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def paper_runs():
    return learning_runs(TAG, BATCH)


def test_learning_rows_equal_the_reference_but_the_times(paper_runs):
    rec, epochs = paper_runs
    assert_learning_rows(rec, TAG, epochs, BATCH)
    assert_reference_rows(rec.rows, "bench_online_learning")


def test_learning_epochs_learn_the_references_bits(paper_runs):
    rec, epochs = paper_runs
    assert_learning_bits(rec, TAG, epochs)
