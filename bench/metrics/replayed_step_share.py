"""replayed_step_share: the window's steps that replayed a captured CUDA
graph over all the window's steps (the step program's replays against
the engine's steps); the rest ran eagerly or were captured."""


def read(run):
    steps = run.delta("engine_steps")
    return run.delta("replays") / steps if steps else None
