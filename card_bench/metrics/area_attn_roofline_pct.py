"""The attention kernel's 32-wide-value form's share of its roofline (%):
the least time of one call's work at the area attention's shapes of a
batch (costs.attention_cost: q, k, v read and the output written once,
the two products at the bf16 peak), averaged over the calls, over the
mean device time of one launch of the form (`attention_v32_bf16_kernel`)
in the trace. A program without the form reads None."""

from card_bench.costs import attention_cost


def read(ctx):
    ops = ctx.trace.ops_named(r"attention_v32_bf16_kernel") if ctx.trace else []
    calls = ctx.layer.get("area_attention_calls")
    if not ops or not calls:
        return None
    bound_ms = sum(attention_cost(*c)[0] for c in calls) / len(calls)
    return 100.0 * bound_ms / (sum(o.seconds for o in ops) * 1e3 / len(ops))
