"""The port's mission-scale scripts, counterparts of the repository's
``scripts/auto_scale.py`` and ``scripts/stress_bench.py``:

    python -m diasss_tpu_torch.scripts.auto_scale [n_lines n_ties n_pings]
    python -m diasss_tpu_torch.scripts.stress_bench [--lines N --pings N ...]

Both run on the card unless called with ``device="cpu"`` (or ``--device
cpu``), and raise without CUDA otherwise.  No failure of a run is caught.
"""

from __future__ import annotations

import torch


def card_device(device, entry: str) -> torch.device:
    """``device``, the card when it is None; raises where CUDA is absent
    unless the caller asked for the CPU.  On the card float32 matmuls and
    convolutions keep full precision (TF32 off), as in the CLI."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{entry} runs on the card and torch.cuda.is_available() is False; "
                               f'call it with device="cpu" to run it on the CPU')
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
