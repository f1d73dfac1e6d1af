"""rollout_graph_share.fleet: 100 x the steps of the traced window's
episodes that a replay of a CUDA graph ran (an episode that holds the
program's span `rollout.replay`, runtime.rollout.EpisodeGraph), over all
the window's steps; nothing outside a rollout cell or where the program
recorded no such span."""

from harness.spans import recorder, window


def read(ctx):
    rec = recorder()
    if rec is None or not ctx.records or ctx.driver_kind != "rollout":
        return None
    replays = [(a, b) for n, a, b in rec.spans(*window(ctx))
               if n == "rollout.replay"]
    if not replays:
        return None
    steps = [len(r["out"]["ks"]) for r in ctx.records]
    replayed = sum(s for r, s in zip(ctx.records, steps)
                   if any(r["start"] <= a and b <= r["end"]
                          for a, b in replays))
    return 100.0 * replayed / sum(steps)
