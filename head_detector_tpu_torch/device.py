"""Device selection and the float32 precision policy of the port.

Entry points take ``device="cuda"`` by default and never move to the CPU on
their own: asking for CUDA where there is none raises.  Tests pass
``device="cpu"``.

Precision: every float32 matrix product and convolution runs in full
float32.  The FLAME contractions need it (a one-pass reduced-precision
product misses the 1e-3 vertex budget), and the detector's convolutions keep
it too, so that the card agrees with the CPU to the same bar (TF32 keeps
about three decimal digits per product, over ~70 stacked layers).  The flags
are set for the duration of a call and restored afterwards, so that importing
or calling the port changes nothing for the rest of the process.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device) -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def exact_float32():
    """Disable TF32 for matmuls and cuDNN convolutions inside the block."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
