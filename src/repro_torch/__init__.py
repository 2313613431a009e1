"""PyTorch + CUDA port of the interleaved approximate-FP32-multiplier CNN
system (the JAX package ``repro`` is its reference).

Float32 matmuls and convolutions must be full float32, as the reference's
are: cuDNN runs float32 convolutions in TF32 by default, so TF32 is turned
off for both here, where the port initialises.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def check_device(device) -> torch.device:
    """The device asked for; raises when it is a CUDA device that is absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but torch.cuda."
                           "is_available() is False")
    return dev
