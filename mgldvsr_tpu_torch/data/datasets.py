"""Training clips: REDS-style GT windows degraded on the fly (stage 1), and
GT / LQ / latent windows read from disk (stage 2).

Counterpart of ``mgldvsr_tpu/data/datasets.py`` (``RealVSRRecurrentDataset``,
``REDSAutoencoderDataset``, ``paired_random_crop``, ``augment``,
``REDS4_CLIPS``, ``ShardedSampler``, ``prefetch_iterator``) without
OpenCV: frames are read through :mod:`mgldvsr_tpu_torch.data.cv_ops` (PNG),
``packed_root`` through the native clip loader
(:class:`~mgldvsr_tpu_torch.native.loader.NativeClipLoader`) where it builds
with its PNG codec, else through
:class:`~mgldvsr_tpu_torch.data.file_client.PackedBackend`. Every draw is
made from the same per-(seed, index) ``RandomState`` in the same order as
the JAX package's. Samples are float32 [T, H, W, 3] RGB in [0, 1].
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from mgldvsr_tpu_torch.data import cv_ops
from mgldvsr_tpu_torch.data.degradations import Clip, DegradationStage, UnsharpMasking

REDS4_CLIPS = ("000", "011", "015", "020")


def _imread(path: str) -> np.ndarray:
    """float32 [0, 1] BGR, as ``cv2.imread`` gives it (the degradations run
    in BGR, like the reference's stage before img2tensor)."""
    img = cv_ops.imread(path, cv_ops.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img.astype(np.float32) / 255.0


def _bgr2rgb(clip: np.ndarray) -> np.ndarray:
    """BGR -> RGB at the dataset's return (img2tensor(bgr2rgb=True))."""
    return np.ascontiguousarray(clip[..., ::-1])


def paired_random_crop(gts: List[np.ndarray], size: int,
                       rng: np.random.RandomState) -> List[np.ndarray]:
    h, w = gts[0].shape[:2]
    if h < size or w < size:
        raise ValueError(f"clip {h}x{w} smaller than crop {size}")
    top = rng.randint(0, h - size + 1)
    left = rng.randint(0, w - size + 1)
    return [g[top: top + size, left: left + size] for g in gts]


def augment(frames: List[np.ndarray], hflip: bool, rot: bool,
            rng: np.random.RandomState) -> List[np.ndarray]:
    do_h = hflip and rng.uniform() < 0.5
    do_v = rot and rng.uniform() < 0.5
    do_t = rot and rng.uniform() < 0.5
    out = []
    for f in frames:
        if do_h:
            f = f[:, ::-1]
        if do_v:
            f = f[::-1]
        if do_t:
            f = f.transpose(1, 0, 2)
        out.append(np.ascontiguousarray(f))
    return out


class RealVSRRecurrentDataset:
    """Stage-1 training clips: GT windows degraded on the fly.

    ``dataroot_gt`` holds one folder of ``%08d.png`` frames per clip (or a
    ``meta_info_file`` lists ``clip frame_count`` lines); ``packed_root``
    reads the frames from a packed record file instead (keys
    ``clip/%08d.png``). The REDS4 or official validation clips are left
    out, or kept alone with ``test_mode``.

    ``read_path`` says how frames are read, chosen once here: ``"disk"``
    (no ``packed_root``), ``"native"`` (the C++ pool of ``io_threads``
    threads decodes, crops and flips; taken where the native library builds
    with its PNG codec) or ``"python"`` (PackedBackend and the Python
    decoder). The three give the same samples bit for bit: the same draws in
    the same order, and the native loader divides by 255 as numpy does."""

    def __init__(
        self,
        dataroot_gt: str,
        meta_info_file: Optional[str] = None,
        num_frame: int = 5,
        gt_size: int = 512,
        interval_list: Sequence[int] = (1,),
        use_hflip: bool = True,
        use_rot: bool = False,
        val_partition: str = "REDS4",
        test_mode: bool = False,
        degradation_1: Optional[Dict] = None,
        degradation_2: Optional[Dict] = None,
        usm_gt: bool = True,
        seed: int = 0,
        packed_root: Optional[str] = None,
        io_threads: int = 4,
    ):
        self.root = dataroot_gt
        self.packed = None
        self.read_path = "disk"
        if packed_root is not None:
            from mgldvsr_tpu_torch import native

            if native.native_available() and "png" in native.codecs():
                from mgldvsr_tpu_torch.native.loader import NativeClipLoader

                self.packed = NativeClipLoader(packed_root, num_threads=io_threads)
                self.read_path = "native"
            else:
                from mgldvsr_tpu_torch.data.file_client import PackedBackend

                self.packed = PackedBackend(packed_root)
                self.read_path = "python"
        self.num_frame = num_frame
        self.gt_size = gt_size
        self.interval_list = list(interval_list)
        self.use_hflip = use_hflip
        self.use_rot = use_rot
        self.seed = seed

        if meta_info_file:
            with open(meta_info_file) as f:
                entries = [line.split(" ") for line in f.read().splitlines() if line]
            clips = [(e[0], int(e[1])) for e in entries]
        else:
            clips = []
            for d in sorted(os.listdir(dataroot_gt)):
                full = os.path.join(dataroot_gt, d)
                if os.path.isdir(full):
                    clips.append((d, len(glob.glob(os.path.join(full, "*.png")))))

        if val_partition == "REDS4":
            val = set(REDS4_CLIPS)
        elif val_partition == "official":
            val = {f"{i:03d}" for i in range(240, 270)}
        else:
            val = set()
        if test_mode:
            clips = [c for c in clips if c[0] in val]
        else:
            clips = [c for c in clips if c[0] not in val]
        self.clips = clips

        self.stage1 = DegradationStage(degradation_1) if degradation_1 else None
        self.stage2 = DegradationStage(degradation_2) if degradation_2 else None
        self.usm = UnsharpMasking(keys=("gts",)) if usm_gt else None
        self.clipper = Clip(keys=("lqs",))

    def __len__(self) -> int:
        return len(self.clips)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1_000_003 + index) % (2**31))
        clip, n_frames = self.clips[index % len(self.clips)]
        interval = int(rng.choice(self.interval_list))
        span = (self.num_frame - 1) * interval
        start = rng.randint(0, max(n_frames - span, 1))
        idxs = [start + i * interval for i in range(self.num_frame)]
        keys = [f"{clip}/{i:08d}.png" for i in idxs]
        if self.read_path == "native":
            # paired_random_crop's and augment's draws, in their order
            h, w = self.packed.probe(keys[0])
            size = self.gt_size
            if h < size or w < size:
                raise ValueError(f"clip {h}x{w} smaller than crop {size}")
            top = rng.randint(0, h - size + 1)
            left = rng.randint(0, w - size + 1)
            do_h = self.use_hflip and rng.uniform() < 0.5
            do_v = self.use_rot and rng.uniform() < 0.5
            do_t = self.use_rot and rng.uniform() < 0.5
            gts = list(self.packed.load_clip(keys, top, left, size, size, hflip=do_h,
                                             vflip=do_v, transpose=do_t))
        else:
            if self.read_path == "python":
                from mgldvsr_tpu_torch.data.file_client import imfrombytes

                gts = [imfrombytes(self.packed.get(k), float32=True) for k in keys]
            else:
                gts = [_imread(os.path.join(self.root, k)) for k in keys]
            gts = paired_random_crop(gts, self.gt_size, rng)
            gts = augment(gts, self.use_hflip, self.use_rot, rng)

        results = {"gts": gts, "lqs": [g.copy() for g in gts]}
        if self.usm is not None:
            results = self.usm(results)
        if self.stage1 is not None:
            results = self.stage1(results, rng)
        if self.stage2 is not None:
            results = self.stage2(results, rng)
        results = self.clipper(results)
        return {
            "lqs": _bgr2rgb(np.stack(results["lqs"]).astype(np.float32)),
            "gts": _bgr2rgb(np.stack(results["gts"]).astype(np.float32)),
            "clip": clip,
            "indices": np.asarray(idxs, np.int32),
        }


class REDSAutoencoderDataset:
    """Stage-2 windows: GT and LQ PNG frames, the diffusion latents the
    latent mode wrote for them (``<clip>/<frame>.npy``, [h, w, 4], times the
    diffusion scale factor), in windows of ``num_frame`` frames aligned to
    multiples of it (every start with ``load_fix_indices_only=False``).
    Frames are float32 RGB in [0, 1]."""

    def __init__(self, dataroot_gt: str, dataroot_lq: str, dataroot_latent: str,
                 num_frame: int = 5, load_fix_indices_only: bool = True):
        self.roots = dict(gt=dataroot_gt, lq=dataroot_lq, latent=dataroot_latent)
        self.num_frame = num_frame
        self.windows = []
        step = num_frame if load_fix_indices_only else 1
        for clip in sorted(os.listdir(dataroot_gt)):
            names = sorted(os.path.basename(f)
                           for f in glob.glob(os.path.join(dataroot_gt, clip, "*.png")))
            for s in range(0, len(names) - num_frame + 1, step):
                self.windows.append((clip, names[s:s + num_frame]))

    def __len__(self) -> int:
        return len(self.windows)

    def _frames(self, root: str, clip: str, names) -> np.ndarray:
        return _bgr2rgb(np.stack([_imread(os.path.join(root, clip, n)) for n in names]))

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        clip, names = self.windows[index]
        return {
            "gts": self._frames(self.roots["gt"], clip, names),
            "lqs": self._frames(self.roots["lq"], clip, names),
            "lts": np.stack([np.load(os.path.join(self.roots["latent"], clip,
                                                  os.path.splitext(n)[0] + ".npy"))
                             for n in names]).astype(np.float32),
            "clip": clip,
        }


class ShardedSampler:
    """EnlargedSampler counterpart (basicsr/data/data_sampler.py:6-48):
    epoch-enlarged, per-shard index stream."""

    def __init__(self, num_samples: int, shard: int = 0, num_shards: int = 1,
                 ratio: int = 1, seed: int = 0):
        self.num_samples = num_samples
        self.shard = shard
        self.num_shards = num_shards
        self.total = num_samples * ratio
        self.seed = seed

    def epoch(self, epoch: int):
        rng = np.random.RandomState(self.seed + epoch)
        order = rng.permutation(self.total) % self.num_samples
        return order[self.shard:: self.num_shards]


_worker_dataset = None
# each worker's BLAS and OpenMP pools: one thread (four workers with pools
# the size of the machine starve the thread that launches the step)
_WORKER_ENV = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _init_worker(dataset) -> None:
    """A prefetch worker: holds ``dataset`` and leaves Ctrl-C and SIGUSR1 to
    the training process."""
    import signal

    global _worker_dataset
    _worker_dataset = dataset
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGUSR1, signal.SIG_IGN)


def _worker_item(index: int):
    return _worker_dataset[index]


def prefetch_iterator(dataset, indices, num_workers: int = 4, queue_size: int = 8):
    """Prefetch in worker processes that keeps the host degradations ahead
    of the device; yields the items in ``indices`` order (which may be
    endless). The JAX package prefetches in threads, which suits a step
    dispatched as one compiled call; an eager PyTorch step takes the GIL
    for each of its thousands of launches, and the degradations hold it
    for most of a clip, so threads beside the step slow it several times
    over. The workers are spawned (no copy of the training process's
    memory), get a pickled ``dataset`` and one BLAS thread each, and run
    numpy only."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx,
                             initializer=_init_worker, initargs=(dataset,)) as ex:
        futures = []
        it = iter(indices)
        # the workers start with the first submissions and read their
        # environment then
        saved = {k: os.environ.get(k) for k in _WORKER_ENV}
        os.environ.update(_WORKER_ENV)
        try:
            for _ in range(queue_size):
                try:
                    futures.append(ex.submit(_worker_item, next(it)))
                except StopIteration:
                    break
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k)
                else:
                    os.environ[k] = v
        try:
            while futures:
                f = futures.pop(0)
                try:
                    futures.append(ex.submit(_worker_item, next(it)))
                except StopIteration:
                    pass
                yield f.result()
        finally:
            for f in futures:  # closed early: drop the items not yet started
                f.cancel()
