"""femus_tpu_torch — the finite-element framework on PyTorch and CUDA.

A port of the ``femus_tpu`` package to PyTorch for NVIDIA Hopper cards.
Host-side set-up (meshes, dof maps, sparsity patterns, transfer schedules,
blocked- and sliced-ELL plans, patch routing tables) is plain numpy/scipy;
device work is torch tensors on an explicit ``device``; the sparse matvecs
run as hand-written CUDA kernels (``algebra/csrc/*.cu``).

Precision policy, set once here: float32 matrix products run in full
float32 (no TF32) everywhere.  Together with the per-element coordinate
centring in ``assembly/engine.py`` this keeps geometric Jacobian
determinants sign-accurate on fine meshes — reduced-precision passes over
absolute coordinates produced zero and negative determinants.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Defaults to CUDA and raises when
    no card is present: a caller who wants the CPU passes ``device="cpu"``
    (there is no silent fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "femus_tpu_torch: CUDA is not available; pass device='cpu' to "
            "run on the host")
    return dev


def default_dtype(device: torch.device) -> torch.dtype:
    """float64 on the host (parity tests), float32 on the card."""
    return torch.float64 if torch.device(device).type == "cpu" else torch.float32
