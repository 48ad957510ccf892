"""The generic jvp engine's partials (complete spans partials.generic, by exact name, any thread) per traced Adam step, in ms; None where no complete span was traced."""

CALL = "partials.generic"


def read(ctx):
    events = ctx["events"]
    if not events or ctx["units"] <= 0:
        return None
    last = max(e for _, _, _, _, e in events)
    ns = sum(e - s for k, n, _, s, e in events
             if k == "host" and n == CALL and e < last)
    return ns / 1e6 / ctx["units"] if ns > 0 else None
