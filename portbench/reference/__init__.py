"""Plain-PyTorch reference of what the benchmark's cells compute.

Each module follows the published description of one stage (LlamaGen's GPT
with ControlAR's control fusion, DINOv2, OpenCV's Canny, LlamaGen's VQ-16
decoder, AdamW) in float32 with no cache, no batching tricks and no kernels.
The weights are dicts of tensors under the released checkpoints' keys, the
ones the benchmark makes from its seed. Nothing here imports the program
under test, JAX, or the JAX package.
"""
import torch


def exact_fp32() -> None:
    """float32 matrix products and convolutions in float32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
