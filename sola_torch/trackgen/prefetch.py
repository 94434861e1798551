"""Lookahead video encoding: overlap the NEXT video's ``init_state`` with
the CURRENT video's propagation passes.

The reference serializes per video — load all JPEG frames, encode every
frame, then run tracking (generate_tokens_grid.py:142-237) — so each
video pays its full encode latency on the critical path. Here a single
worker thread runs video k+1's ``init_state`` (JPEG decode, frame upload,
encoder launches) while the main thread propagates video k. PyTorch
launches from two threads onto the device queue; the threads contend only
for the host and the device, which is the overlap wanted.

Depth is one group (``groups``: the next video, or the next pack of
videos): deeper lookahead buys nothing once encode time <= propagation
time. Pass ``enabled=False`` (CLI
``--prefetch_videos 0``) to restore the strictly serial order, e.g. for
memory-tight long-video runs.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterator, Optional


class StatePrefetcher:
    """One-video-ahead ``init_state`` pipeline around a video predictor."""

    def __init__(self, predictor, enabled: bool = True):
        self.predictor = predictor
        self._pool = (ThreadPoolExecutor(max_workers=1,
                                         thread_name_prefix="sola-prefetch")
                      if enabled else None)
        self._pending: dict = {}

    def schedule(self, key, frames_dir: Optional[str]) -> None:
        """Queue ``init_state`` for ``key`` (no-op if queued/disabled)."""
        if self._pool is None or key in self._pending or frames_dir is None:
            return
        self._pending[key] = self._pool.submit(
            self.predictor.init_state, None, video_path=frames_dir)

    def get(self, key, frames_dir: Optional[str]):
        """The encoded state for ``key`` — from the lookahead if it was
        scheduled, else encoded inline (identical result either way)."""
        fut: Optional[Future] = self._pending.pop(key, None)
        if fut is not None:
            return fut.result()
        return self.predictor.init_state(None, video_path=frames_dir)

    def groups(self, keys: list, n: int,
               frames_dir_of: Callable[[str], str]) -> Iterator[tuple]:
        """``keys`` in groups of ``n``, each yielded as ``(group,
        states)``. Before a group is yielded its encodes and the next
        group's are scheduled, so the next group encodes while the caller
        tracks this one; disabled, each state encodes inline."""
        for g0 in range(0, len(keys), n):
            for key in keys[g0:g0 + 2 * n]:
                self.schedule(key, frames_dir_of(key))
            group = keys[g0:g0 + n]
            yield group, [self.get(key, frames_dir_of(key))
                          for key in group]

    def close(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False, cancel_futures=True)
            self._pending.clear()

    def __enter__(self) -> "StatePrefetcher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
