"""A folder of LQ clips, each a folder of frames: the inference input
layout (VideoLQ). Counterpart of ``VideoFolderDataset`` in
``mgldvsr_tpu/data/datasets.py``, reading frames with
:mod:`mgldvsr_tpu_torch.io.frames` instead of OpenCV.
"""
from __future__ import annotations

import os
from typing import Iterator, List, Tuple

import numpy as np

from mgldvsr_tpu_torch.io.frames import read_frame

FRAME_SUFFIXES = (".png", ".jpg", ".jpeg")


class VideoFolderDataset:
    """Clips are the sub-folders of ``root`` sorted by name; a clip's
    frames are its ``.png``/``.jpg``/``.jpeg`` files sorted by name."""

    def __init__(self, root: str, num_frame: int = 5):
        self.root = root
        self.num_frame = num_frame
        self.clips = [d for d in sorted(os.listdir(root))
                      if os.path.isdir(os.path.join(root, d))]

    def __len__(self) -> int:
        return len(self.clips)

    def frame_paths(self, index: int) -> List[str]:
        folder = os.path.join(self.root, self.clips[index])
        return [os.path.join(folder, n) for n in sorted(os.listdir(folder))
                if n.lower().endswith(FRAME_SUFFIXES)]

    def segments(self, index: int) -> Iterator[Tuple[str, List[str], np.ndarray]]:
        """(clip, frame names, frames [num_frame, H, W, 3] float32 RGB in
        [0,1]) for each window of ``num_frame`` frames; the last window is
        padded by repeating its last frame, and ``names`` lists only the
        real ones."""
        clip = self.clips[index]
        paths = self.frame_paths(index)
        for s in range(0, len(paths), self.num_frame):
            chunk = paths[s:s + self.num_frame]
            names = [os.path.basename(p) for p in chunk]
            while len(chunk) < self.num_frame:
                chunk.append(chunk[-1])
            frames = np.stack([read_frame(p) for p in chunk]).astype(np.float32) / 255.0
            yield clip, names, frames
