"""Profiling and FLOP accounting.

Port of ``nequip_tpu/utils/profiling.py`` for PyTorch:

* :func:`flops_per_step` counts the FLOPs of one call with
  ``torch.utils.flop_counter.FlopCounterMode``.  The registered ops
  (``torch.ops.nequip_torch.*``: the CUDA kernels of ``tp_impl`` "fused" and
  "fused_tp") are opaque to it, as Pallas calls are to XLA's cost analysis:
  count a model's FLOPs on the same model at ``tp_impl="torch"``, whose
  convolution is plain PyTorch;
* :func:`mfu` divides a FLOP rate by a peak that the caller names;
* :func:`trace` writes a ``torch.profiler`` trace (a Chrome trace JSON that
  TensorBoard's profiler plugin and Perfetto read);
* :class:`TorchProfilerCallback` traces a window of training steps, the
  twin of the JAX package's ``JaxProfilerCallback``.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Any, Dict

import torch

log = logging.getLogger("nequip_tpu_torch")

# peaks of one NVIDIA H100 SXM at its 700 W power limit, dense (NVIDIA's data
# sheet): bf16 on the tensor cores, TF32 on the tensor cores, float32 outside them
H100_BF16_FLOP_S, H100_TF32_FLOP_S, H100_F32_FLOP_S = 989e12, 495e12, 67e12


def flops_per_step(fn, *args, **kwargs) -> float:
    """The FLOPs of one call ``fn(*args, **kwargs)`` by PyTorch's FLOP counter
    (matrix products and convolutions; registered ops count nothing, see the
    module docstring)."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def mfu(flops: float, seconds: float, peak_flops: float) -> float:
    """Model FLOP utilization against ``peak_flops`` FLOP/s, which the caller
    names for the card and dtype it ran (e.g. ``H100_BF16_FLOP_S``, at the
    card's full 700 W power limit)."""
    return flops / seconds / peak_flops


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _profiler(log_dir: str) -> torch.profiler.profile:
    os.makedirs(log_dir, exist_ok=True)
    return torch.profiler.profile(activities=_activities(),
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into ``log_dir`` (``*.pt.trace.json``); yields the
    ``torch.profiler.profile``, whose ``key_averages()`` sums time by op."""
    prof = _profiler(log_dir)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        log.info(f"profiler trace written to {log_dir}")


class TorchProfilerCallback:
    """Trainer callback: trace steps [start_step, end_step) to ``log_dir``.

    The defaults skip the first steps (the kernels' build and first
    launches) and capture a short window.  In a config:

    .. code-block:: yaml

        trainer:
          callbacks:
            - _target_: nequip_tpu_torch.utils.profiling.TorchProfilerCallback
              log_dir: ./profile
              start_step: 5
              end_step: 8
    """

    def __init__(self, log_dir: str = "./profile", start_step: int = 5, end_step: int = 8):
        if not end_step > start_step >= 0:
            raise ValueError(f"need end_step > start_step >= 0, got {start_step}, {end_step}")
        self.log_dir = log_dir
        self.start_step = int(start_step)
        self.end_step = int(end_step)
        self._prof = None
        self._done = False

    def _stop(self) -> None:
        self._prof.stop()
        self._prof = None
        self._done = True
        log.info(f"profiler: trace written to {self.log_dir}")

    def on_train_start(self, trainer, module) -> None: ...

    def on_train_epoch_start(self, trainer, module, epoch: int) -> None: ...

    def on_train_batch_end(self, trainer, module, logs: Dict[str, Any], step: int) -> None:
        if self._done:
            return
        if self._prof is None and step >= self.start_step:
            self._prof = _profiler(self.log_dir)
            self._prof.start()
            log.info(f"profiler: tracing from step {step}")
        elif self._prof is not None and step >= self.end_step:
            self._stop()

    def on_train_epoch_end(self, trainer, module, epoch: int, metrics) -> None:
        if self._prof is not None:  # short runs: close the trace at the epoch's end
            self._stop()

    def on_validation_epoch_end(self, trainer, module, epoch: int, metrics) -> None: ...

    def on_test_epoch_end(self, trainer, module, metrics) -> None: ...

    def state_dict(self) -> dict:
        return {"done": self._done}

    def load_state_dict(self, state: dict) -> None:
        self._done = bool(state.get("done", False))


# the JAX package's name, which a JAX training config retargeted to the port
# (``utils.config.retarget``) names
JaxProfilerCallback = TorchProfilerCallback
