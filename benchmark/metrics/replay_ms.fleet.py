"""replay_ms.fleet: the mean of the program's span `rollout.replay` (one
episode replayed as a CUDA graph: the copies of its inputs, the replay's
enqueueing and the clones of its outputs, runtime.rollout.EpisodeGraph)
over the traced window; nothing where the program recorded no such
span."""

from harness.spans import span_ns


def read(ctx):
    got = span_ns(ctx, "rollout.replay")
    return sum(got) / 1e6 / len(got) if got else None
