"""Profiling and debug-visualization hooks.

Counterpart of ``mgldvsr_tpu/utils/profiling.py``:

- ``trace``: a ``torch.profiler`` trace of the CPU and, where there is one,
  the CUDA device, written as a Chrome trace into a folder, on a CUPTI
  attached anew (``reattach_cupti``);
- ``check_kernels``: the device kernels of a finished profiler session, or
  an error where a launch call of it has no kernel;
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


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block; writes ``trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto) into ``logdir``. Yields the
    profiler. With a CUDA device, CUPTI is attached anew for the session
    (``reattach_cupti``), the device is synchronised at both ends of the
    block, and a session with a launch call whose kernel it did not record
    raises ``EmptyTraceError`` (after the file is written). Leaves
    ``TEARDOWN_CUPTI=0``: kineto keeps CUPTI attached after the session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    cuda = torch.cuda.is_available()
    if cuda:
        reattach_cupti()
    os.environ["TEARDOWN_CUPTI"] = "0"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    if cuda:
        check_kernels(prof, f"trace({logdir})")


# seconds given kineto's teardown thread on each side of the CUDA call it
# finalises CUPTI in, and the verifying sessions reattach_cupti may take
REATTACH_WAIT_S = 0.05
REATTACH_TRIES = 5


def reattach_cupti() -> None:
    """Make the next ``torch.profiler`` session run on a CUPTI attached
    anew, and leave ``TEARDOWN_CUPTI=0``.

    With ``TEARDOWN_CUPTI=0`` kineto keeps CUPTI attached between sessions,
    and in a long process CUPTI goes stale: later sessions record the launch
    calls but lose some or all of the kernels (on an H100: after sessions
    and graph captures, two minutes of device work, or traced training
    steps). With ``TEARDOWN_CUPTI=1``,
    kineto tears CUPTI down after a session from a thread of its own, which
    finalises CUPTI in the exit of the next CUDA call, whichever session
    that falls in; that session then records nothing, launch calls
    included. So: one session that ends with ``TEARDOWN_CUPTI=1``, a CUDA
    call outside any session for the finalise to land in, then sessions that
    end with ``TEARDOWN_CUPTI=0`` until one records its launch: CUPTI is
    attached anew and nothing is left to fire later."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def session(teardown: str) -> int:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.ones(1, device="cuda")  # a launch for the session to record
            torch.cuda.synchronize()
            os.environ["TEARDOWN_CUPTI"] = teardown  # kineto reads it as the session stops
        os.environ["TEARDOWN_CUPTI"] = "0"
        return _kernels_and_launches(prof)[0]

    session("1")
    for _ in range(REATTACH_TRIES):
        time.sleep(REATTACH_WAIT_S)
        torch.cuda.synchronize()  # the call the finalise lands in, outside any session
        time.sleep(REATTACH_WAIT_S)
        if session("0"):
            return
    raise EmptyTraceError(f"reattach_cupti: {REATTACH_TRIES} sessions after CUPTI's teardown "
                          f"recorded no kernel")


# substrings of the names of the CUDA API calls that launch device work
LAUNCH_CALLS = ("LaunchKernel", "GraphLaunch")


class EmptyTraceError(RuntimeError):
    """A profiler session recorded launch calls without their device kernels."""


def _kernels_and_launches(prof) -> tuple[int, int, int]:
    """(device kernels, kernel launch calls, launch calls with no device
    activity of their correlation id) of a finished session."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    kernels = 0
    on_device, launches = set(), []
    for e in prof.events():
        if e.device_type == cuda:
            kernels += not e.name.startswith(("Memcpy", "Memset"))
            on_device.add(e.id)
        elif any(k in e.name for k in LAUNCH_CALLS):
            launches.append(e.id)
    return kernels, len(launches), sum(i not in on_device for i in launches)


def check_kernels(prof, where: str, launched: bool = False) -> int:
    """The number of device kernels in a finished ``torch.profiler`` session
    (memsets and copies not counted). Raises ``EmptyTraceError``, naming
    ``where``, when a kernel launch call of the session has no device
    activity of its correlation id (CUPTI lost that kernel), or when the
    session holds no device kernel and launch calls (or the caller says it
    ``launched`` some): a device time read from the session would be short
    in silence."""
    kernels, launches, lost = _kernels_and_launches(prof)
    if lost:
        raise EmptyTraceError(f"{where}: {lost} of the profiler session's {launches} launch "
                              f"calls have no device kernel: CUPTI lost their kernel activity")
    if not kernels and (launches or launched):
        raise EmptyTraceError(f"{where}: the profiler session holds no device kernel: CUPTI "
                              f"recorded no kernel activity")
    return kernels


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
