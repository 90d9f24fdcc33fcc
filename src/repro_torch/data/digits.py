"""Deterministic synthetic handwritten-digit dataset.

The container has no network/dataset access, so MNIST (Sec 4.4.2) is replaced
by a procedural digit distribution: 7x5 glyph bitmaps upscaled to 28x28,
randomly shifted (+-3 px), dilated, and corrupted with per-pixel flip noise.
The generator is fully deterministic in its seed.  DESIGN.md §8 records the
substitution: accuracy on this set validates the BNN->SNN pipeline, not the
paper's absolute 97.64 % MNIST figure.
"""

from __future__ import annotations

import numpy as np

_GLYPHS = {
    0: ["01110", "10001", "10001", "10001", "10001", "10001", "01110"],
    1: ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],
    2: ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],
    3: ["01110", "10001", "00001", "00110", "00001", "10001", "01110"],
    4: ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],
    5: ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],
    6: ["01110", "10000", "10000", "11110", "10001", "10001", "01110"],
    7: ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],
    8: ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],
    9: ["01110", "10001", "10001", "01111", "00001", "00001", "01110"],
}


def _glyph_array(d: int) -> np.ndarray:
    return np.array([[int(c) for c in row] for row in _GLYPHS[d]], dtype=np.float32)


def make_digits(
    n: int, seed: int = 0, flip_noise: float = 0.02, img: int = 28, max_shift: int = 2
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (images float32[n, img, img] in {0,1}, labels int32[n]).

    Digits are roughly centred with +-max_shift jitter (MNIST digits are
    size-normalised and centred, so small jitter is the faithful analogue).
    """
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    images = np.zeros((n, img, img), np.float32)
    scale = 3  # 7x5 -> 21x15 core
    for i, d in enumerate(labels):
        g = np.kron(_glyph_array(int(d)), np.ones((scale, scale), np.float32))
        # random dilation: thicken strokes with 50% probability
        if rng.random() < 0.5:
            gpad = np.pad(g, 1)
            g = np.maximum(g, np.maximum(gpad[2:, 1:-1], gpad[1:-1, 2:]))
        h, w = g.shape
        cy, cx = (img - h) // 2, (img - w) // 2
        dy = int(np.clip(cy + rng.integers(-max_shift, max_shift + 1), 0, img - h))
        dx = int(np.clip(cx + rng.integers(-max_shift, max_shift + 1), 0, img - w))
        images[i, dy : dy + h, dx : dx + w] = g
    flips = rng.random(images.shape) < flip_noise
    images = np.where(flips, 1.0 - images, images)
    return images, labels


def corner_crop_mask(img: int = 28, corner: int = 2) -> np.ndarray:
    """Boolean keep-mask removing a corner x corner block from each corner
    (784 -> 768, Sec 4.4.2: 'a 2x2 set of pixels is removed from every
    corner')."""
    keep = np.ones((img, img), bool)
    keep[:corner, :corner] = False
    keep[:corner, -corner:] = False
    keep[-corner:, :corner] = False
    keep[-corner:, -corner:] = False
    return keep


def make_spike_dataset(
    n: int, seed: int = 0, flip_noise: float = 0.02
) -> tuple[np.ndarray, np.ndarray]:
    """Binary spike vectors (n, 768) + labels, ready for the 768:...:10 net."""
    images, labels = make_digits(n, seed, flip_noise)
    mask = corner_crop_mask()
    spikes = images.reshape(n, -1)[:, mask.reshape(-1)]
    assert spikes.shape[1] == 768
    return spikes.astype(np.float32), labels
