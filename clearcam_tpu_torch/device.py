"""Device selection. The port never falls back to the CPU on its own: the
CPU is used only when a caller asks for it by name."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) raises when no CUDA device is usable;
    ``"cpu"`` gives the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                f"is False (torch {torch.__version__}); pass device='cpu' to "
                "run on the CPU explicitly")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


def card_line(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, for a
    line beside its numbers; on the CPU, a line saying the numbers are the
    host's."""
    if dev.type != "cuda":
        return "device: cpu (host numbers, not a card's)"
    import subprocess
    return "nvidia-smi: " + subprocess.run(
        ["nvidia-smi", f"--id={dev.index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
