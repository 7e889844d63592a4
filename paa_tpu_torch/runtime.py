"""Device selection and the numeric policy for runs on the GPU."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """Return the CUDA device, or raise when there is none.

    Sets the float32 policy explicitly: matmuls and cuDNN convolutions run
    in full float32 (PyTorch's default lets cuDNN use TF32, about three
    decimal digits). bfloat16 is the model's compute type on the main path.
    """
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this path runs only on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")
