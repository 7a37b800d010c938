"""repro_torch.data — the per-host training loader (a verbatim copy of
``repro.data.loader``; numpy and threads only)."""
from .loader import LoaderConfig, SyntheticTokenSource, TrainLoader

__all__ = ["LoaderConfig", "SyntheticTokenSource", "TrainLoader"]
