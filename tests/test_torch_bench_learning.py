"""The Sec 4.4.1 learning bench (``launch.bench_online_learning``) on the
CPU against the reference's ``benchmarks/bench_online_learning.py``.

At a cut batch (16 samples) the learning bench's two planes learn the
reference's bits and update counts on the 768x10 readout (the draws are
the reference's, through ``core/prng.py``), and every row but the times
equals the reference bench's, field for field.  The paper topology's
epochs are held in ``test_torch_bench_learning_paper.py``, the
online-learning example in ``test_torch_online_learning.py``."""

from __future__ import annotations

import io
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
from torch_bench_rows import (LEARNING_TAGS, assert_learning_bits,
                              assert_learning_rows, assert_reference_rows,
                              learning_runs, one_torch_thread,  # noqa: F401
                              parse_rows)

from repro_torch.launch import bench_online_learning, online_learning

BATCH = 16
TAG = LEARNING_TAGS[0]

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def readout_runs(tmp_path_factory):
    """The port's bench at ``BATCH``; the reference's epochs on the
    readout's bits, digits and key; the reference bench's own rows with
    its epochs stubbed (its static rows, and its bit-identity row as it
    reads when the two planes agree)."""
    from benchmarks import bench_online_learning as ref

    rec, epochs = learning_runs(TAG, BATCH)
    mp = pytest.MonkeyPatch()
    mp.setattr(ref, "BATCH", BATCH)
    mp.setattr(ref, "_bench_pair", lambda *a, **k: 1.0)
    for name in ("online_learning_epoch", "online_learning_epoch_scan"):
        mp.setattr(ref.learning, name,
                   lambda *a, **k: (np.zeros((1,), np.int8), 0))
    mp.setenv("BENCH_LEARNING_OUT",
              str(tmp_path_factory.mktemp("learn") / "l.json"))
    try:
        buf = io.StringIO()
        with redirect_stdout(buf):
            ref.run()
    finally:
        mp.undo()
    return rec, epochs, parse_rows(buf.getvalue())


def test_learning_rows_equal_the_reference_but_the_times(readout_runs):
    rec, epochs, want = readout_runs
    got = {r["name"]: r for r in rec.rows}
    assert list(got) == [
        "learning_1rw_baseline", "learning_4r_transposed",
        "learning_epoch_scan_768x10", "learning_epoch_column_event_768x10",
        "learning_epoch_scan_768x256x256x256x10",
        "learning_epoch_column_event_768x256x256x256x10",
        "learning_bit_identity"]
    # the reference's static rows and its bit-identity row, field for field
    for ref_row in want:
        assert got[ref_row["name"]]["derived"] == ref_row["derived"]
        assert got[ref_row["name"]]["us_per_call"] == 0.0
    assert [r["name"] for r in want] == [
        "learning_1rw_baseline", "learning_4r_transposed",
        "learning_bit_identity"]
    assert_learning_rows(rec, TAG, epochs, BATCH)
    assert_reference_rows(rec.rows, "bench_online_learning")


def test_learning_epochs_learn_the_references_bits(readout_runs):
    rec, epochs, _ = readout_runs
    assert_learning_bits(rec, TAG, epochs)


def test_learning_bench_books_its_launches_by_device():
    """On the CPU nothing is booked; the bench's per-plane launch tables
    are the card's (3 for the matrix-RNG epoch, 2 for the fused one)."""
    assert sum(bench_online_learning.SCAN_LAUNCHES.values()) == 3
    assert sum(bench_online_learning.FUSED_LAUNCHES.values()) == 2


def test_online_learning_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        online_learning.run()
    with pytest.raises(RuntimeError):
        bench_online_learning.run()
