"""Image loading with background prefetch (port of correlation_tpu/io.py).

A thread pool decodes frames ahead of the solve.  PIL is imported inside
load_image, so the package imports without it.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np


def load_image(path: str, monochrome: bool = True) -> np.ndarray:
    """Decode an image file to [H, W, C] float32 with uint8 values.

    monochrome=True converts to single-channel luma (the reference's
    cv::IMREAD_GRAYSCALE default, manager_class.cpp:100-104).
    """
    from PIL import Image

    with Image.open(path) as im:
        if monochrome:
            im = im.convert("L")
            arr = np.asarray(im, np.float32)[..., None]
        else:
            im = im.convert("RGB")
            arr = np.asarray(im, np.float32)
    return arr


class FramePrefetcher:
    """Decode frames ahead of the solver (the std::async analog).

    Keeps up to `ahead` decoded frames in flight and evicts frames that
    fall behind the newest request, so a length-N sequence holds O(ahead)
    decoded frames — not O(N) — mirroring the reference's three-image
    recycling (pyramid_class.cpp:211-258).  Evicted frames are re-decoded
    transparently if requested again (e.g. for overlay rendering).
    """

    def __init__(self, paths: list[str], monochrome: bool = True,
                 ahead: int = 2, behind: int = 1):
        self.paths = paths
        self.monochrome = monochrome
        self.ahead = ahead
        self.behind = behind
        self.max_cached = 0  # high-water mark, asserted bounded by tests
        self._pool = ThreadPoolExecutor(max_workers=2)
        self._futures: dict[int, Future] = {}
        for i in range(min(ahead, len(paths))):
            self._submit(i)

    def _submit(self, idx: int):
        if 0 <= idx < len(self.paths) and idx not in self._futures:
            self._futures[idx] = self._pool.submit(
                load_image, self.paths[idx], self.monochrome
            )

    def get(self, idx: int) -> np.ndarray:
        self._submit(idx)
        for j in range(idx + 1, min(idx + 1 + self.ahead, len(self.paths))):
            self._submit(j)
        out = self._futures[idx].result()
        # Evict decoded frames behind the window (run_sequence keeps the
        # und/def pyramids it still needs on the device).
        for k in [k for k in self._futures if k < idx - self.behind]:
            f = self._futures.pop(k)
            f.cancel()
        self.max_cached = max(self.max_cached, len(self._futures))
        return out

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
