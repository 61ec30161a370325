"""ms a unit (a sequence in the full cell, a round in the sweep) in
pipeline.slam_pipeline.fetch_many's one copy to the host: the program's
span `fetch` (utils.profiling.recorded()). In the sweep no span
synchronises, so this is the host's wait for the device's work of the
round, which the other spans only launched. In the full cell every span
reaches the benchmark's synchronising Spans: the front end's inner spans
have drained the device before its fetch, while the loop query's and the
loop verification's fetches still wait for their own work."""


def read(ctx):
    from aria_slam_tpu_torch.utils import profiling

    units = ctx["units"]
    if not hasattr(profiling, "recorded") or not units:
        return None
    s = profiling.recorded().total_s("fetch")
    return None if s is None else 1e3 * s / units
