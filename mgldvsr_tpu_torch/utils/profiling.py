"""Profiling and debug-visualization hooks.

Counterpart of ``mgldvsr_tpu/utils/profiling.py``:

- ``trace``: a ``torch.profiler`` trace of the CPU and, where there is one,
  the CUDA device, written as a Chrome trace into a folder;
- ``StepTimer``: wall-clock step times, fenced by synchronising the CUDA
  device of each tensor handed to ``stop``;
- ``device_memory_stats``: the device's live, peak and total bytes;
- ``pca_components`` and ``dump_pca_features``: struct-cond feature maps
  projected onto their top principal components, written as PNG sequences.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np


# Seconds of idle device kept at each end of a traced block. After a
# process's first profiler session, CUPTI's device timestamps sit up to a
# few milliseconds off the host clock that bounds the profiler's window (on
# an H100), and kineto drops every device activity outside the window.
TRACE_MARGIN_S = 0.02


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; writes ``trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto) into ``logdir``. Yields the
    profiler. With a CUDA device, the block's device work is kept
    ``TRACE_MARGIN_S`` inside each end of the profiler's window.

    Sets ``TEARDOWN_CUPTI=0`` unless it is set: kineto then keeps CUPTI
    attached between sessions for the rest of the process (as torch does
    where it captures CUDA graphs). With the teardown, every later session
    in a process could lose all its kernels: a trace of one kernel named none
    after earlier profiler sessions and CUDA graph captures."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
        yield prof
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TRACE_MARGIN_S)
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock timing that waits for the device's queued work."""

    def __init__(self):
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, *tensors):
        """Record the time since ``start``, once the CUDA device of each
        tensor given has finished its queued work."""
        import torch

        for t in tensors:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                torch.cuda.synchronize(t.device)
        self.times.append(time.perf_counter() - self._t0)

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    @property
    def best(self) -> float:
        return float(np.min(self.times)) if self.times else 0.0


def device_memory_stats(device=None) -> Dict[str, int]:
    """Live and peak bytes allocated on a device and its total memory;
    zeros for the CPU."""
    import torch

    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) \
            if torch.cuda.is_available() else torch.device("cpu")
    device = torch.device(device)
    if device.type != "cuda":
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    return {"bytes_in_use": torch.cuda.memory_allocated(device),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(device),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory}


def pca_components(feature_hwc: np.ndarray, n: int = 3) -> np.ndarray:
    """Project an [H, W, C] feature map onto its top-``n`` principal
    components -> [H, W, n] float32."""
    h, w, c = feature_hwc.shape
    x = np.asarray(feature_hwc).reshape(-1, c).astype(np.float64)
    x = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    proj = x @ vt[:n].T
    return proj.reshape(h, w, n).astype(np.float32)


def dump_pca_features(features_per_step: List[Dict[str, np.ndarray]], outdir: str,
                      keys: tuple = ("64", "32"), n_components: int = 3):
    """Write the struct-cond features of each sampling step (``[B, H, W, C]``
    arrays or tensors by width key; the first sample is taken) as
    ``fea_<key>/step_<n>.png``, three components scaled jointly to [0, 255].
    The components go to the files as cv2.imwrite takes them (as B, G, R),
    byte for byte the files the JAX package writes."""
    from mgldvsr_tpu_torch.io.frames import encode_png

    if n_components != 3:
        raise ValueError(f"the PNGs hold 3 components, got n_components={n_components}")
    for key in keys:
        maps = [pca_components(_numpy(step[key][0]), n_components)
                for step in features_per_step if key in step]
        if not maps:
            continue
        arr = np.stack(maps)
        arr = arr - arr.min()
        arr = arr / max(arr.max(), 1e-8)
        d = os.path.join(outdir, f"fea_{key}")
        os.makedirs(d, exist_ok=True)
        for i, m in enumerate(arr):
            bgr = (m * 255).astype(np.uint8)
            with open(os.path.join(d, f"step_{len(arr) - i}.png"), "wb") as f:
                f.write(encode_png(np.ascontiguousarray(bgr[..., ::-1]), opencv=True))


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
