"""The whole serving step's share of the card's bf16 peak (%): the
forward's operations (convs and the attention products, from the
reference model's shapes, costs.model_flops) of every image served in
the window, over the window's time, against 989.4 TFLOP/s. NMS and the
copies count no operations, so this bounds every kernel's share."""

from card_bench.costs import PEAK_BF16


def read(ctx):
    w = ctx.window
    if not w.get("items"):
        return None
    return 100.0 * w["items"] * ctx.layer["flops_per_item"] / w["window_s"] / PEAK_BF16
