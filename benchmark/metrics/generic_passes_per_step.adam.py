"""The generic jvp engine's passes (complete spans partials.generic.pass, by exact name, any thread: a pair pass, a first pass or a nested directional) per traced Adam step; None where none was traced."""

PASS = "partials.generic.pass"


def read(ctx):
    events = ctx["events"]
    if not events or ctx["units"] <= 0:
        return None
    last = max(e for _, _, _, _, e in events)
    n = sum(1 for k, name, _, _, e in events
            if k == "host" and name == PASS and e < last)
    return n / ctx["units"] if n else None
