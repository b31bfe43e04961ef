"""BasicSR-heritage datasets: REDS, Vimeo-90K and the video and image test
protocols, without OpenCV.

Counterpart of ``mgldvsr_tpu/data/heritage_datasets.py``: the same
``np.random.RandomState(seed)`` draws in the same order, so the same files
and seed give the same crops, frames read through
:mod:`mgldvsr_tpu_torch.data.cv_ops` (PNG) and augmented by
:func:`mgldvsr_tpu_torch.data.datasets.augment`. Items are numpy dicts of
float32 RGB frames in [0, 1], [T, H, W, C] stacks. ``duf_downsample`` runs
``cv_ops.filter2D`` with a zero border; its 13x13 kernel takes the FFT path,
which agrees with OpenCV's to about 1e-6 (not bit for bit).
"""
from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from mgldvsr_tpu_torch.data import cv_ops
from mgldvsr_tpu_torch.data.datasets import augment
from mgldvsr_tpu_torch.data.file_client import FileClient


def paired_crop(gts: List[np.ndarray], lqs: List[np.ndarray], gt_size: int, scale: int,
                rng: np.random.RandomState):
    """Aligned random crop: ``gt_size`` on the GT frames, ``gt_size // scale``
    on the LQ frames."""
    lq_size = gt_size // scale
    hl, wl = lqs[0].shape[:2]
    if hl < lq_size or wl < lq_size:
        raise ValueError(f"LQ {hl}x{wl} smaller than crop {lq_size}")
    top = rng.randint(0, hl - lq_size + 1)
    left = rng.randint(0, wl - lq_size + 1)
    lqs = [im[top:top + lq_size, left:left + lq_size] for im in lqs]
    tg, lg = top * scale, left * scale
    gts = [im[tg:tg + gt_size, lg:lg + gt_size] for im in gts]
    return gts, lqs


def _imread01(path) -> np.ndarray:
    img = cv_ops.imread(str(path), cv_ops.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return img[..., ::-1].astype(np.float32) / 255.0


def generate_frame_indices(crt_idx: int, max_frame_num: int, num_frames: int,
                           padding: str = "reflection") -> List[int]:
    """Indices of a window around ``crt_idx`` with border padding
    (``replicate``, ``reflection``, ``reflection_circle`` or ``circle``)."""
    assert num_frames % 2 == 1, "num_frames should be an odd number"
    assert padding in ("replicate", "reflection", "reflection_circle", "circle"), padding
    max_frame_num = max_frame_num - 1
    num_pad = num_frames // 2
    indices = []
    for i in range(crt_idx - num_pad, crt_idx + num_pad + 1):
        if i < 0:
            pad_idx = {"replicate": 0, "reflection": -i,
                       "reflection_circle": crt_idx + num_pad - i,
                       "circle": num_frames + i}[padding]
        elif i > max_frame_num:
            pad_idx = {"replicate": max_frame_num, "reflection": max_frame_num * 2 - i,
                       "reflection_circle": (crt_idx - num_pad) - (i - max_frame_num),
                       "circle": i - num_frames}[padding]
        else:
            pad_idx = i
        indices.append(pad_idx)
    return indices


def duf_downsample(x: np.ndarray, kernel_size: int = 13, scale: int = 4) -> np.ndarray:
    """DUF's Gaussian downsampling of [t, h, w, c] frames: a 13-tap Gaussian
    (sigma 0.4 * scale), reflect padding, sampling at stride ``scale``, a
    2-pixel crop."""
    assert scale in (2, 3, 4), scale
    ax = np.arange(kernel_size) - kernel_size // 2
    sigma = 0.4 * scale
    g = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k2 = np.outer(g, g)
    k2 /= k2.sum()
    pad = kernel_size // 2 + scale * 2
    half = kernel_size // 2
    t, h, w, c = x.shape
    out = []
    for fi in range(t):
        chans = []
        for ci in range(c):
            img = np.pad(x[fi, :, :, ci], pad, mode="reflect")
            f = cv_ops.filter2D(img, -1, k2, borderType=cv_ops.BORDER_CONSTANT)
            valid = f[half:img.shape[0] - half:scale, half:img.shape[1] - half:scale]
            chans.append(valid[2:-2, 2:-2])
        out.append(np.stack(chans, axis=-1))
    return np.stack(out).astype(np.float32)


def _read_meta_keys(meta_info_file: str) -> List[str]:
    keys = []
    with open(meta_info_file) as fin:
        for line in fin:
            if line.strip():
                folder, frame_num = line.split(" ")[:2]
                keys.extend(f"{folder}/{i:08d}" for i in range(int(frame_num)))
    return keys


def _val_partition(kind: str) -> List[str]:
    if kind == "REDS4":
        return ["000", "011", "015", "020"]
    if kind == "official":
        return [f"{v:03d}" for v in range(240, 270)]
    raise ValueError(f"Wrong validation partition {kind!r} (supported: 'official', 'REDS4')")


def dequantize_flow(dx: np.ndarray, dy: np.ndarray, max_val: float = 20.0,
                    denorm: bool = False) -> np.ndarray:
    """uint8 levels [0, 255] -> flow values in [-max_val, max_val]."""
    flow = np.stack([dx, dy], axis=-1).astype(np.float32)
    flow = flow * (2 * max_val / 255.0) - max_val
    if denorm:
        flow[..., 0] *= flow.shape[1]
        flow[..., 1] *= flow.shape[0]
    return flow


class REDSDataset:
    """REDS training windows around a centre frame: {'lqs': [t,h,w,c], 'gt':
    [h,w,c], 'key'} (+ 'flows' with ``flow_root``)."""

    def __init__(self, gt_root: str, lq_root: str, meta_info_file: str,
                 val_partition: str = "REDS4", num_frame: int = 5, gt_size: int = 256,
                 scale: int = 4, interval_list: Sequence[int] = (1,),
                 random_reverse: bool = False, use_hflip: bool = True, use_rot: bool = True,
                 flow_root: Optional[str] = None, frames_per_clip: int = 100, seed: int = 0):
        assert num_frame % 2 == 1, "num_frame should be odd"
        self.gt_root, self.lq_root, self.flow_root = gt_root, lq_root, flow_root
        self.num_frame = num_frame
        self.half = num_frame // 2
        self.gt_size, self.scale = gt_size, scale
        self.interval_list = list(interval_list)
        self.random_reverse = random_reverse
        self.use_hflip, self.use_rot = use_hflip, use_rot
        self.frames_per_clip = frames_per_clip
        val = set(_val_partition(val_partition))
        self.keys = [k for k in _read_meta_keys(meta_info_file) if k.split("/")[0] not in val]
        self.rng = np.random.RandomState(seed)
        self.client = FileClient()

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        key = self.keys[index]
        clip, frame_name = key.split("/")
        center = int(frame_name)
        interval = int(self.rng.choice(self.interval_list))
        last = self.frames_per_clip - 1
        start = center - self.half * interval
        end = center + self.half * interval
        while start < 0 or end > last:
            center = int(self.rng.randint(0, last + 1))
            start = center - self.half * interval
            end = center + self.half * interval
        neighbors = list(range(start, end + 1, interval))
        if self.random_reverse and self.rng.rand() < 0.5:
            neighbors.reverse()
        gt = _imread01(os.path.join(self.gt_root, clip, f"{center:08d}.png"))
        lqs = [_imread01(os.path.join(self.lq_root, clip, f"{n:08d}.png")) for n in neighbors]
        flows = None
        if self.flow_root is not None:
            flows = [self._read_flow(clip, center, f"p{i}") for i in range(self.half, 0, -1)]
            flows += [self._read_flow(clip, center, f"n{i}") for i in range(1, self.half + 1)]
            lqs = lqs + flows
        [gt], lqs = paired_crop([gt], lqs, self.gt_size, self.scale, self.rng)
        if flows is not None:
            lqs, flows = lqs[:self.num_frame], lqs[self.num_frame:]
        frames = augment(lqs + [gt], self.use_hflip, self.use_rot, self.rng)
        out = {"lqs": np.stack(frames[:-1]), "gt": frames[-1], "key": key}
        if flows is not None:
            flows.insert(self.half, np.zeros_like(flows[0]))
            out["flows"] = np.stack(flows)
        return out

    def _read_flow(self, clip: str, center: int, tag: str) -> np.ndarray:
        path = os.path.join(self.flow_root, clip, f"{center:08d}_{tag}.png")
        cat = cv_ops.imread(path, cv_ops.IMREAD_GRAYSCALE)
        if cat is None:
            raise FileNotFoundError(path)
        dx, dy = np.split(cat, 2, axis=0)
        return dequantize_flow(dx, dy, max_val=20.0)


class REDSRecurrentDataset:
    """REDS sequences of ``num_frame`` frames: {'lqs', 'gts', 'key'}."""

    def __init__(self, gt_root: str, lq_root: str, meta_info_file: str,
                 val_partition: str = "REDS4", num_frame: int = 15, gt_size: int = 256,
                 scale: int = 4, interval_list: Sequence[int] = (1,),
                 random_reverse: bool = False, use_hflip: bool = True, use_rot: bool = True,
                 test_mode: bool = False, frames_per_clip: int = 100, seed: int = 0):
        self.gt_root, self.lq_root = gt_root, lq_root
        self.num_frame = num_frame
        self.gt_size, self.scale = gt_size, scale
        self.interval_list = list(interval_list)
        self.random_reverse = random_reverse
        self.use_hflip, self.use_rot = use_hflip, use_rot
        self.frames_per_clip = frames_per_clip
        val = set(_val_partition(val_partition))
        self.keys = [k for k in _read_meta_keys(meta_info_file)
                     if (k.split("/")[0] in val) == bool(test_mode)]
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        key = self.keys[index]
        clip, frame_name = key.split("/")
        interval = int(self.rng.choice(self.interval_list))
        start = int(frame_name)
        limit = self.frames_per_clip - self.num_frame * interval
        if start > limit:
            start = int(self.rng.randint(0, limit + 1))
        neighbors = list(range(start, start + self.num_frame * interval, interval))
        if self.random_reverse and self.rng.rand() < 0.5:
            neighbors.reverse()
        lqs = [_imread01(os.path.join(self.lq_root, clip, f"{n:08d}.png")) for n in neighbors]
        gts = [_imread01(os.path.join(self.gt_root, clip, f"{n:08d}.png")) for n in neighbors]
        gts, lqs = paired_crop(gts, lqs, self.gt_size, self.scale, self.rng)
        t = len(lqs)
        frames = augment(lqs + gts, self.use_hflip, self.use_rot, self.rng)
        return {"lqs": np.stack(frames[:t]), "gts": np.stack(frames[t:]), "key": key}


class Vimeo90KDataset:
    """Vimeo-90K septuplets with the centre frame (im4) as GT."""

    recurrent = False

    def __init__(self, gt_root: str, lq_root: str, meta_info_file: str, num_frame: int = 7,
                 gt_size: int = 256, scale: int = 4, random_reverse: bool = False,
                 use_hflip: bool = True, use_rot: bool = True, flip_sequence: bool = False,
                 seed: int = 0):
        self.gt_root, self.lq_root = gt_root, lq_root
        with open(meta_info_file) as fin:
            self.keys = [line.split(" ")[0] for line in fin if line.strip()]
        if self.recurrent:
            self.neighbor_list = [1, 2, 3, 4, 5, 6, 7]
        else:
            self.neighbor_list = [i + (9 - num_frame) // 2 for i in range(num_frame)]
        self.gt_size, self.scale = gt_size, scale
        self.random_reverse = random_reverse
        self.use_hflip, self.use_rot = use_hflip, use_rot
        self.flip_sequence = flip_sequence
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        if self.random_reverse and self.rng.rand() < 0.5:
            self.neighbor_list.reverse()
        key = self.keys[index]
        clip, seq = key.split("/")
        lqs = [_imread01(os.path.join(self.lq_root, clip, seq, f"im{n}.png"))
               for n in self.neighbor_list]
        if self.recurrent:
            gts = [_imread01(os.path.join(self.gt_root, clip, seq, f"im{n}.png"))
                   for n in self.neighbor_list]
        else:
            gts = [_imread01(os.path.join(self.gt_root, clip, seq, "im4.png"))]
        gts, lqs = paired_crop(gts, lqs, self.gt_size, self.scale, self.rng)
        t = len(lqs)
        frames = augment(lqs + gts, self.use_hflip, self.use_rot, self.rng)
        lqs, gts = frames[:t], frames[t:]
        if self.recurrent:
            out = {"lqs": np.stack(lqs), "gts": np.stack(gts), "key": key}
            if self.flip_sequence:  # 7 frames -> 14
                out["lqs"] = np.concatenate([out["lqs"], out["lqs"][::-1]])
                out["gts"] = np.concatenate([out["gts"], out["gts"][::-1]])
            return out
        return {"lqs": np.stack(lqs), "gt": gts[0], "key": key}


class Vimeo90KRecurrentDataset(Vimeo90KDataset):
    recurrent = True


class VideoTestDataset:
    """One item a centre frame: its padded window of LQ frames and its GT."""

    def __init__(self, gt_root: str, lq_root: str, num_frame: int = 5,
                 padding: str = "reflection", meta_info_file: Optional[str] = None,
                 cache_data: bool = False):
        self.num_frame = num_frame
        self.padding = padding
        self.cache_data = cache_data
        if meta_info_file:
            with open(meta_info_file) as fin:
                subs = [line.split(" ")[0] for line in fin if line.strip()]
            lq_dirs = [os.path.join(lq_root, s) for s in subs]
            gt_dirs = [os.path.join(gt_root, s) for s in subs]
        else:
            lq_dirs = sorted(glob.glob(os.path.join(lq_root, "*")))
            gt_dirs = sorted(glob.glob(os.path.join(gt_root, "*")))
        self.info = []  # (folder, idx, max_idx, border)
        self.lq_paths: Dict[str, List[str]] = {}
        self.gt_paths: Dict[str, List[str]] = {}
        self.cache: Dict[str, np.ndarray] = {}
        for lq_d, gt_d in zip(lq_dirs, gt_dirs):
            name = os.path.basename(lq_d)
            lq_paths = sorted(glob.glob(os.path.join(lq_d, "*")))
            gt_paths = sorted(glob.glob(os.path.join(gt_d, "*")))
            assert len(lq_paths) == len(gt_paths), (lq_d, gt_d)
            n = len(lq_paths)
            self.lq_paths[name] = lq_paths
            self.gt_paths[name] = gt_paths
            for i in range(n):
                border = 1 if (i < num_frame // 2 or i >= n - num_frame // 2) else 0
                self.info.append((name, i, n, border))
            if cache_data:
                self.cache[name] = np.stack([_imread01(p) for p in lq_paths])
                self.cache[name + "/gt"] = np.stack([_imread01(p) for p in gt_paths])

    def __len__(self):
        return len(self.info)

    def _window(self, folder: str, sel: List[int]) -> np.ndarray:
        if self.cache_data:
            return self.cache[folder][sel]
        return np.stack([_imread01(self.lq_paths[folder][i]) for i in sel])

    def _gt(self, folder: str, idx: int) -> np.ndarray:
        if self.cache_data:
            return self.cache[folder + "/gt"][idx]
        return _imread01(self.gt_paths[folder][idx])

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        folder, idx, n, border = self.info[index]
        sel = generate_frame_indices(idx, n, self.num_frame, self.padding)
        return {"lqs": self._window(folder, sel), "gt": self._gt(folder, idx),
                "folder": folder, "idx": f"{idx}/{n}", "border": border,
                "lq_path": self.lq_paths[folder][idx]}


class VideoTestVimeo90KDataset:
    """Vimeo-90K test protocol: the centre frame only."""

    def __init__(self, gt_root: str, lq_root: str, meta_info_file: str, num_frame: int = 7):
        with open(meta_info_file) as fin:
            self.keys = [line.split(" ")[0] for line in fin if line.strip()]
        self.gt_root, self.lq_root = gt_root, lq_root
        self.neighbor_list = [i + (9 - num_frame) // 2 for i in range(num_frame)]

    def __len__(self):
        return len(self.keys)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        key = self.keys[index]
        clip, seq = key.split("/")
        lqs = np.stack([_imread01(os.path.join(self.lq_root, clip, seq, f"im{n}.png"))
                        for n in self.neighbor_list])
        gt = _imread01(os.path.join(self.gt_root, clip, seq, "im4.png"))
        return {"lqs": lqs, "gt": gt, "folder": key, "idx": f"{index}/{len(self.keys)}",
                "border": 0}


def _mod_crop(img: np.ndarray, scale: int) -> np.ndarray:
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale]


class VideoTestDUFDataset(VideoTestDataset):
    """DUF's test protocol: optionally the LQ window made from the GT frames
    by :func:`duf_downsample`."""

    def __init__(self, *args, use_duf_downsampling: bool = False, scale: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_duf = use_duf_downsampling
        self.scale = scale

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        folder, idx, n, border = self.info[index]
        sel = generate_frame_indices(idx, n, self.num_frame, self.padding)
        if self.use_duf:
            gts = np.stack([_mod_crop(_imread01(self.gt_paths[folder][i]), self.scale)
                            for i in sel])
            lqs = duf_downsample(gts, kernel_size=13, scale=self.scale)
        else:
            lqs = self._window(folder, sel)
        gt = _mod_crop(self._gt(folder, idx), self.scale)
        return {"lqs": lqs, "gt": gt, "folder": folder, "idx": f"{idx}/{n}", "border": border,
                "lq_path": self.lq_paths[folder][idx]}


class VideoRecurrentTestDataset(VideoTestDataset):
    """Whole clips: one item a folder, {'lqs', 'gts', 'folder'}."""

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("cache_data", True)
        super().__init__(*args, **kwargs)
        self.folders = sorted(self.lq_paths)

    def __len__(self):
        return len(self.folders)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        folder = self.folders[index]
        return {"lqs": self.cache[folder], "gts": self.cache[folder + "/gt"], "folder": folder}


class PairedImageDataset:
    """Paired LQ / GT images from two folders; a crop and augmentation in the
    ``train`` phase."""

    def __init__(self, gt_root: str, lq_root: str, gt_size: Optional[int] = None,
                 scale: int = 4, phase: str = "test", use_hflip: bool = True,
                 use_rot: bool = True, seed: int = 0):
        self.gt_paths = sorted(glob.glob(os.path.join(gt_root, "*")))
        self.lq_paths = sorted(glob.glob(os.path.join(lq_root, "*")))
        assert len(self.gt_paths) == len(self.lq_paths)
        self.gt_size, self.scale, self.phase = gt_size, scale, phase
        self.use_hflip, self.use_rot = use_hflip, use_rot
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.gt_paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        gt = _imread01(self.gt_paths[index])
        lq = _imread01(self.lq_paths[index])
        if self.phase == "train" and self.gt_size:
            [gt], [lq] = paired_crop([gt], [lq], self.gt_size, self.scale, self.rng)
            gt, lq = augment([gt, lq], self.use_hflip, self.use_rot, self.rng)
        return {"lq": lq, "gt": gt, "lq_path": self.lq_paths[index],
                "gt_path": self.gt_paths[index]}


class SingleImageDataset:
    """LQ images only."""

    def __init__(self, lq_root: str):
        self.lq_paths = sorted(glob.glob(os.path.join(lq_root, "*")))

    def __len__(self):
        return len(self.lq_paths)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        return {"lq": _imread01(self.lq_paths[index]), "lq_path": self.lq_paths[index]}
