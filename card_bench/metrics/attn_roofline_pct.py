"""The PSA attention kernel's share of its roofline (%): the least time of
one call's work at the call's shapes (costs.attention_cost: q, k, v read
and the output written once, the two products at the bf16 peak) over
the mean device time of one launch in the trace."""

from card_bench.costs import attention_cost


def read(ctx):
    ops = ctx.trace.ops_named(r"attention_\w*kernel") if ctx.trace else []
    calls = ctx.layer.get("attention_calls")
    if not ops or not calls:
        return None
    bound_ms = sum(attention_cost(*c)[0] for c in calls) / len(calls)
    return 100.0 * bound_ms / (sum(o.seconds for o in ops) * 1e3 / len(ops))
