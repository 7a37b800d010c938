"""repro_torch.kernels — hand-written Hopper kernels, each beside its plain
PyTorch version. ``paged_decode_attention`` launches the CUDA kernel on
CUDA tensors and runs ``paged_attention_plain`` on CPU tensors."""
from .paged_attention import paged_attention_plain, paged_decode_attention

__all__ = ["paged_decode_attention", "paged_attention_plain"]
