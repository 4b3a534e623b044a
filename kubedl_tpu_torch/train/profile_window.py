"""The trainer's ``--profile-dir`` window over torch.profiler (the port of
kubedl_tpu/train/profile_window.py, same discipline).

The trace covers ``[start_step+1, start_step+1+n_steps)`` -- skipping the
first step, which builds the kernels and warms the libraries -- and
``stop()`` is

  * idempotent: the flag flips before the profiler call, so the SIGTERM
    path, the end of the loop and the ``finally`` backstop can all call it;
  * exception-safe: a profiler that refuses to stop logs and moves on, so
    a trace hiccup never turns a clean checkpoint exit into a crash.

On stop the trace is written to ``<profile_dir>/trace-<pid>.json`` (Chrome
trace format, readable in Perfetto) with CPU and, when there is a card,
CUDA activity.
"""
from __future__ import annotations

import os
import sys
from typing import Optional


class ProfileWindow:
    def __init__(self, profile_dir: str, start_step: int, n_steps: int = 5) -> None:
        self.profile_dir = profile_dir
        self.start_at = start_step + 1 if profile_dir else -1
        self.stop_after = self.start_at + max(n_steps, 1)
        self.tracing = False
        self._prof = None

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()

    def _stop(self) -> None:
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        os.makedirs(self.profile_dir, exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(self.profile_dir, f"trace-{os.getpid()}.json"))

    def maybe_start(self, step: int) -> None:
        """Call at the top of the step loop, before dispatching the step."""
        if step == self.start_at and not self.tracing:
            self.tracing = True
            try:
                self._start()
            except Exception as e:  # noqa: BLE001 -- profiling is best-effort
                self.tracing = False
                print(f"profiler start failed: {e}", file=sys.stderr)

    def should_stop(self, step: int) -> bool:
        """True when the step just completed closes the traced window (the
        caller synchronizes the device first, so the trace holds finished
        work)."""
        return self.tracing and step + 1 >= self.stop_after

    def stop(self) -> None:
        if not self.tracing:
            return
        self.tracing = False  # flip first: re-entry is a no-op
        try:
            self._stop()
            print(f"profile written to {self.profile_dir}", flush=True)
        except Exception as e:  # noqa: BLE001 -- trace loss must not crash exit
            print(f"profiler stop failed: {e}", file=sys.stderr)


def window_from_args(args, start_step: int) -> Optional[ProfileWindow]:
    """ProfileWindow from --profile-dir / --profile-steps; None when off."""
    if not args.profile_dir:
        return None
    return ProfileWindow(args.profile_dir, start_step, n_steps=args.profile_steps)
