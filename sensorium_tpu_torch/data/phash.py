"""Perceptual hashing for group-k-fold assignment of video trials.

A copy of ``sensorium_tpu/data/phash.py``. Several trials share identical
stimulus videos; folds are assigned by a 64-bit perceptual hash of the video
so duplicates always land in the same fold.

The hash is the classic pHash (the ``imagehash`` package's): resize the
frame to 32x32 with Lanczos resampling, take the 2-D DCT-II, keep the
top-left 8x8 block, threshold it at its median, and pack the 64 bits
MSB-first. A video's hash is the XOR of the hashes of five frames sampled
evenly over its NaN-trimmed length. Fold id = hash % num_folds.

Pillow and scipy are imported when a frame is hashed, not with the module:
only the phash fold assignment needs them (``SENSORIUM_FOLD_ASSIGNMENT=trial``
does not).
"""

from __future__ import annotations

import numpy as np

from sensorium_tpu_torch.utils.misc import get_length_without_nan

HASH_SIZE = 8
HIGHFREQ_FACTOR = 4


def pack_bits(bits: np.ndarray) -> int:
    """Pack a flat boolean array into an int, first element = MSB."""
    value = 0
    for bit in np.asarray(bits, dtype=np.uint8).ravel():
        value = (value << 1) | int(bit)
    return value


def frame_phash(frame: np.ndarray) -> int:
    """64-bit pHash of a single grayscale frame (H, W) of uint8 range."""
    from PIL import Image
    from scipy.fftpack import dct

    img_size = HASH_SIZE * HIGHFREQ_FACTOR
    image = Image.fromarray(frame.astype(np.uint8), "L")
    image = image.resize((img_size, img_size), Image.Resampling.LANCZOS)
    pixels = np.asarray(image)
    freq = dct(dct(pixels, axis=0), axis=1)
    low = freq[:HASH_SIZE, :HASH_SIZE]
    return pack_bits(low > np.median(low))


def video_phash(video: np.ndarray, num_hash_frames: int = 5) -> int:
    """XOR of the pHashes of ``num_hash_frames`` frames sampled evenly from
    ``video`` (H, W, T); frames past the first NaN are ignored."""
    length = get_length_without_nan(video[0, 0])
    if length < num_hash_frames:
        raise ValueError(f"video has {length} usable frames, need >= {num_hash_frames} to hash")
    step = length // num_hash_frames
    combined = 0
    for frame_index in range(step // 2, length, step)[:num_hash_frames]:
        combined ^= frame_phash(video[..., frame_index])
    return combined
