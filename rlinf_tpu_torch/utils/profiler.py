"""Profiling hooks: torch.profiler traces with step-window gating.

Port of ``rlinf_tpu/utils/profiler.py`` on ``torch.profiler``. Reference
analog: PyTorchProfiler with chrome-trace export (reference
rlinf/utils/profiler.py:46-214) and the step-window wrapping of the
reference's runners (embodied_runner.py:459-477). One Chrome trace per
window, viewable in Perfetto or chrome://tracing: on a machine with a card,
its kernels and the runtime calls that launched them (CUPTI); without one,
the host's operators. The card's trace leaves the host's operators out: a
decode-bound step launches a few dozen small kernels a layer, each behind
several host operators, and a trace of them all would run to gigabytes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ProfilerConfig:
    """Mirrors the reference ``cluster.profiling`` YAML group."""

    enabled: bool = False
    output_dir: str = "profiles"
    start_step: int = 3          # skip warmup steps
    num_steps: int = 2


class StepProfiler:
    """Call ``step_start/step_end`` around each global step; a trace is
    captured for steps [start_step, start_step + num_steps) and written as
    ``<output_dir>/trace_steps_<first>-<last>.json`` (``trace_path``). The
    finished profile stays readable as ``profile`` (``key_averages()``,
    ``events()``)."""

    def __init__(self, cfg: ProfilerConfig):
        self.cfg = cfg
        self._active = False
        self._step = 0
        self.profile: Optional[torch.profiler.profile] = None
        self.trace_path: Optional[str] = None

    def step_start(self):
        if (
            self.cfg.enabled
            and not self._active
            and self._step == self.cfg.start_step
        ):
            os.makedirs(self.cfg.output_dir, exist_ok=True)
            activity = (torch.profiler.ProfilerActivity.CUDA if torch.cuda.is_available()
                        else torch.profiler.ProfilerActivity.CPU)
            self.profile = torch.profiler.profile(activities=[activity])
            self.profile.start()
            self._active = True

    def step_end(self):
        self._step += 1
        if (
            self._active
            and self._step >= self.cfg.start_step + self.cfg.num_steps
        ):
            self._stop()

    def close(self):
        if self._active:
            self._stop()

    def _stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.profile.stop()
        self._active = False
        first = self.cfg.start_step
        self.trace_path = os.path.join(
            self.cfg.output_dir, f"trace_steps_{first}-{self._step - 1}.json")
        self.profile.export_chrome_trace(self.trace_path)


@contextlib.contextmanager
def annotate(name: str):
    """Named region in the trace (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield
