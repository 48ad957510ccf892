"""The share of the hard-BC lift-and-bubble calls (spans partials.lift_bubble)
in the traced L-BFGS stretch that reused the partials kept for their point set
(a span partials.lift_bubble.hit inside the call, same thread), in %.

Complete spans only, by exact name.  A program that keeps no partials opens
no hit span and reads 0; a stretch without a complete call reads None."""

CALL, HIT = "partials.lift_bubble", "partials.lift_bubble.hit"


def read(ctx):
    events = ctx["events"]
    if not events:
        return None
    last = max(e for _, _, _, _, e in events)
    spans = [(n, t, s, e) for k, n, t, s, e in events
             if k == "host" and n in (CALL, HIT) and e < last]
    calls = [(t, s, e) for n, t, s, e in spans if n == CALL]
    if not calls:
        return None
    hits = sum(1 for n, t, s, e in spans if n == HIT and any(
        t == ct and cs <= s and e <= ce for ct, cs, ce in calls))
    return 100.0 * hits / len(calls)
