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
import threading

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


_FLAGS_LOCK = threading.Lock()
_flags_depth = 0
_flags_saved = (False, True)


@contextlib.contextmanager
def exact_float32():
    """Disable TF32 for matmuls and cuDNN convolutions inside the block.

    The flags are process-wide, and loader threads decode FLAME while the
    main thread trains, so entries are counted under a lock: the first
    entrant saves the flags, the last one out restores them (a per-entry
    save and restore would, interleaved across threads, leave the flags off
    or restore them under another thread's block)."""
    global _flags_depth, _flags_saved
    with _FLAGS_LOCK:
        if _flags_depth == 0:
            _flags_saved = (torch.backends.cuda.matmul.allow_tf32,
                            torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        _flags_depth += 1
    try:
        yield
    finally:
        with _FLAGS_LOCK:
            _flags_depth -= 1
            if _flags_depth == 0:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = _flags_saved
