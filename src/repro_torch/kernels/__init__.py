"""repro_torch.kernels — hand-written Hopper kernels, each beside its plain
PyTorch version. On CUDA tensors each wrapper launches its CUDA kernel (or
raises); on CPU tensors it runs the plain version:

* ``paged_decode_attention`` / ``paged_attention_plain`` — paged decode
  and chunk attention out of the KV pool (serving, paged plane);
* ``decode_attention`` / ``decode_attention_plain`` — flash-decoding
  against contiguous caches (serving, gather plane), optionally with each
  row's log-sum-exp, and ``merge_partials``, which merges such attentions
  over disjoint key ranges (the mesh path's sequence-sharded caches);
* ``flash_attention`` / ``flash_attention_plain`` — the training and
  prefill forward's attention: causal or windowed self-attention, an
  image prefix (``prefix_len``), an encoder's bidirectional attention and
  a decoder's cross-attention (Sq != Skv) (``flash_attention_forward``:
  the same route without autograd, returning the log-sum-exp too); its
  backward is plain PyTorch (``flash_attention_bwd_plain``);
* ``rglru_scan`` / ``rglru_scan_plain`` — the RG-LRU recurrence of the
  training forward, forward and reverse (backward) mode
  (``rglru_scan_bwd_plain``);
* ``rwkv6_wkv`` / ``rwkv6_wkv_plain`` — RWKV6's chunked WKV of the training
  forward (``rwkv6_wkv_forward``: the same route without autograd); its
  backward is autograd's of ``rwkv6_wkv_chunked``, the reference model's
  chunk-parallel form in plain PyTorch."""
from .decode_attention import (decode_attention, decode_attention_plain,
                               merge_partials)
from .flash_attention import (flash_attention, flash_attention_bwd_plain,
                              flash_attention_forward, flash_attention_plain)
from .paged_attention import paged_attention_plain, paged_decode_attention
from .rglru_scan import (rglru_scan, rglru_scan_bwd_plain, rglru_scan_plain,
                         rglru_scan_reverse)
from .rwkv6_scan import (rwkv6_wkv, rwkv6_wkv_chunked, rwkv6_wkv_forward,
                         rwkv6_wkv_plain)

__all__ = ["paged_decode_attention", "paged_attention_plain",
           "decode_attention", "decode_attention_plain", "merge_partials",
           "flash_attention", "flash_attention_forward",
           "flash_attention_plain", "flash_attention_bwd_plain",
           "rglru_scan", "rglru_scan_plain", "rglru_scan_bwd_plain",
           "rglru_scan_reverse", "rwkv6_wkv", "rwkv6_wkv_chunked",
           "rwkv6_wkv_forward", "rwkv6_wkv_plain"]
