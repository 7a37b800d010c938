"""prefill_saved_frac: the engine's prompt tokens restored from the store
over all prompt tokens it admitted, counted over the window
(prefill_tokens_skipped / (prefill_tokens + prefill_tokens_skipped))."""


def read(run):
    skipped = run.delta("prefill_tokens_skipped")
    total = run.delta("prefill_tokens") + skipped
    return skipped / total if total else None
