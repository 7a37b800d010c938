"""repro_torch.data — the lineage-DAG pipeline with its LERC block cache
and the per-host training loader (verbatim copies of
``repro.data.pipeline`` and ``repro.data.loader``; numpy and threads
only)."""
from .loader import LoaderConfig, SyntheticTokenSource, TrainLoader
from .pipeline import DataRef, ExecStats, Executor, Pipeline

__all__ = ["LoaderConfig", "SyntheticTokenSource", "TrainLoader",
           "DataRef", "ExecStats", "Executor", "Pipeline"]
