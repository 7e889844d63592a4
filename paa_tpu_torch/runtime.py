"""Device selection and the numeric policy for runs on the GPU."""

from __future__ import annotations

import os

import torch


def require_cuda() -> torch.device:
    """Return this process's CUDA device, or raise when there is none.

    The device is ``cuda:(LOCAL_RANK mod device_count)``: under ``torchrun``
    each rank of a node takes its own card while there are enough, and ranks
    share the cards round-robin when there are more ranks than cards; without
    ``torchrun`` it is ``cuda:0``. The device becomes the current one.

    Sets the float32 policy explicitly: matmuls and cuDNN convolutions run
    in full float32 (PyTorch's default lets cuDNN use TF32, about three
    decimal digits). bfloat16 is the model's compute type on the main path.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    index = int(os.environ.get("LOCAL_RANK", "0")) % torch.cuda.device_count()
    torch.cuda.set_device(index)
    return torch.device("cuda", index)
