"""Device policy of the port: the card unless the caller asks for the CPU.

Every entry point of ``repro_torch`` takes ``device=``.  ``None`` means
``"cuda"``; when CUDA is absent and the caller did not name the CPU, the
entry point raises instead of quietly running on the host.  Scheduling is
float64 end to end, so the tensors this package makes name their dtype.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no card is visible.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
