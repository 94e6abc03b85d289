"""Where the port's tensors live when the caller does not say.

Every public function and class of the port that takes a ``device``
resolves it here: ``None`` means the CUDA card, and without one it
raises, so nothing falls back to the CPU unasked.  The CPU is used only
when the caller names it (``device='cpu'``), as the tests do.
"""
import torch


def default_device():
    """The CUDA card; raises where there is none (pass ``device='cpu'``
    to run the plain PyTorch versions on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            'chroma_tpu_torch: no CUDA device is available; pass '
            "device='cpu' to run on the CPU")
    return torch.device('cuda')


def resolve(device):
    """``device`` as a ``torch.device``; ``None`` is the card."""
    return torch.device(device if device is not None else default_device())
