"""The float32 precision the port's command lines run in."""
from __future__ import annotations

import contextlib

TF32_LINE = "tf32 off: float32 matmuls and cuDNN convolutions run in full float32"


@contextlib.contextmanager
def tf32_off():
    """Turn TF32 off for float32 matmuls and cuDNN convolutions inside the
    block and put both flags back as they were after it. PyTorch's default
    lets cuDNN run float32 convolutions in TF32 (about three decimal
    digits); every check of the card against the CPU ran without it."""
    import torch

    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = before
