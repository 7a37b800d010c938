"""repro_torch.kernels — hand-written Hopper kernels, each beside its plain
PyTorch version. ``paged_decode_attention`` and ``decode_attention`` launch
their CUDA kernels on CUDA tensors and run ``paged_attention_plain`` and
``decode_attention_plain`` on CPU tensors."""
from .decode_attention import decode_attention, decode_attention_plain
from .paged_attention import paged_attention_plain, paged_decode_attention

__all__ = ["paged_decode_attention", "paged_attention_plain",
           "decode_attention", "decode_attention_plain"]
