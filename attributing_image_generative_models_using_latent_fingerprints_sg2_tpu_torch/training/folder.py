"""Real-image training data: a deterministic image-folder dataset
(the reference package's ``training/folder.py``).

Files are found recursively and sorted, decoded, center-cropped and
area-resampled to the training size: by the native C++ decoder
(``utils/native_io.py``, PNG and JPEG, one ctypes call a batch) when it is
built, else by PIL and the numpy resample of ``utils/image.py``; the two
agree to one uint8 step.  This is host I/O, not a device path.  A background
thread decodes ahead of the training step.

The batch schedule is a pure function of (seed, epoch): a permutation a
epoch from numpy's PCG64, wrapping across epochs, the reference package's
schedule index for index, so a resumed run sees the uninterrupted run's
images.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Sequence

import numpy as np

from ..utils import native_io
from ..utils.image import load_image, to_training_range

IMAGE_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")
NATIVE_EXTENSIONS = (".png", ".jpg", ".jpeg")


class ImageFolder:
    """Deterministic image-folder dataset: index -> file is stable across
    runs and hosts."""

    def __init__(self, root: str, img_size: int, extensions: Sequence[str] = IMAGE_EXTENSIONS):
        self.root = root
        self.img_size = int(img_size)
        exts = tuple(e.lower() for e in extensions)
        files: List[str] = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            files.extend(os.path.join(dirpath, f) for f in sorted(filenames) if f.lower().endswith(exts))
        if not files:
            raise FileNotFoundError(f"no images with extensions {exts} under {root!r}")
        self.files = files
        self._all_png = all(f.lower().endswith(".png") for f in files)
        self._all_native = all(f.lower().endswith(NATIVE_EXTENSIONS) for f in files)

    @property
    def native_decode(self) -> bool:
        """True when batches take the native decoder."""
        return ((self._all_native and native_io.image_read_available())
                or (self._all_png and native_io.read_available()))

    def __len__(self) -> int:
        return len(self.files)

    def load_batch(self, indices: Sequence[int], n_threads: int = 0) -> np.ndarray:
        """[len(indices), S, S, 3] float32 in [-1, 1]."""
        paths = [self.files[i] for i in indices]
        if self._all_native and native_io.image_read_available():
            u8 = native_io.load_image_rgb_batch(paths, self.img_size, n_threads)
        elif self._all_png and native_io.read_available():
            u8 = native_io.load_png_rgb_batch(paths, self.img_size, n_threads)
        else:
            u8 = np.stack([load_image(p, self.img_size) for p in paths])
        return to_training_range(u8)

    def schedule(self, seed: int, batch: int, steps: int, start: int = 0) -> Iterator[np.ndarray]:
        """Index arrays of steps ``start .. start + steps - 1``; a new
        permutation each epoch (index math only, no decode)."""
        n = len(self.files)
        epoch, pos = divmod(start * batch, n)
        perm = np.random.default_rng(np.uint64(seed) + np.uint64(epoch)).permutation(n)
        for _ in range(steps):
            idx = np.empty(batch, dtype=np.int64)
            filled = 0
            while filled < batch:
                take = min(batch - filled, n - pos)
                idx[filled:filled + take] = perm[pos:pos + take]
                filled += take
                pos += take
                if pos == n:
                    epoch, pos = epoch + 1, 0
                    perm = np.random.default_rng(np.uint64(seed) + np.uint64(epoch)).permutation(n)
            yield idx

    def batches(self, seed: int, batch: int, steps: int, prefetch: int = 2, n_threads: int = 0,
                start: int = 0) -> Iterator[np.ndarray]:
        """[batch, S, S, 3] float32 batches of the schedule, decoded up to
        ``prefetch`` batches ahead on a background thread; a decode error is
        raised to the consumer at the failing batch."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, prefetch))
        stop = threading.Event()

        def producer():
            try:
                for idx in self.schedule(seed, batch, steps, start=start):
                    if stop.is_set():
                        return
                    q.put(self.load_batch(idx, n_threads))
                q.put(None)  # end of stream
            except Exception as e:  # noqa: BLE001 - handed to the consumer, which raises it
                q.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so a producer blocked on a full queue sees ``stop`` and ends
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
