"""output_tokens_per_s: output tokens computed by the steps that finished
on the device inside the window, over the window's seconds."""


def read(run):
    tokens = sum(s.out_tokens for s in run.steps if s.t <= run.window_s)
    return tokens / run.window_s if tokens else None
