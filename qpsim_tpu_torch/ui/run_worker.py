"""Tk-independent simulation worker: background thread + live-frame queue.

Port of ``qpsim_tpu.ui.run_worker``, after the reference GUI's
worker/queue/poll design: the solver runs in a plain thread, live frames
cross to the UI through a ``queue.Queue``, and the Tk side drains it from an
``after()`` poll loop.  Kept free of any Tk import so the whole run pipeline
is testable headlessly, and runnable on a machine with a card and no Tk.
The run goes through :func:`qpsim_tpu_torch.runner.run_setup` on
``device`` ("cuda" by default, "cpu" for the plain PyTorch path).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from ..models.params import SetupData
from ..runner import run_setup

__all__ = ["SimulationWorker", "LiveFrame"]


@dataclass
class LiveFrame:
    time_ns: float
    frame: np.ndarray


@dataclass
class SimulationWorker:
    """Run a setup in a daemon thread, streaming progress into queues.

    ``live`` receives :class:`LiveFrame` per stored step;
    ``result`` receives ``("ok", (result, saved_path))`` or
    ``("error", exception)`` exactly once.  ``device`` is the run's
    ("cuda" raises into ``result`` without a card).
    """

    setup: SetupData
    setup_path: Any | None = None
    save: bool = True
    device: str = "cuda"
    live: "queue.Queue[LiveFrame]" = field(default_factory=queue.Queue)
    result: "queue.Queue[tuple[str, Any]]" = field(default_factory=queue.Queue)
    _thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            raise RuntimeError("Worker already started.")

        def emit(t: float, frame: np.ndarray) -> None:
            try:
                self.live.put_nowait(LiveFrame(time_ns=float(t), frame=frame))
            except Exception:
                pass

        def work() -> None:
            try:
                result, path = run_setup(
                    self.setup,
                    setup_path=self.setup_path,
                    progress_callback=emit,
                    save=self.save,
                    device=self.device,
                )
                self.result.put(("ok", (result, path)))
            except Exception as exc:  # surfaced to the UI thread
                self.result.put(("error", exc))

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def is_running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def drain_live(self, max_items: int = 64) -> list[LiveFrame]:
        frames = []
        for _ in range(max_items):
            try:
                frames.append(self.live.get_nowait())
            except queue.Empty:
                break
        return frames

    def poll_result(self):
        """Non-blocking: ('ok'|'error', payload) or None while running."""
        try:
            return self.result.get_nowait()
        except queue.Empty:
            return None

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)
