"""elementwise_ms: device ms a step in kernels that the frozen
``categorize`` calls elementwise or reduction (BatchNorm's passes, bias
adds, activations, casts, the losses' sums), from the traced steps."""


def read(ctx):
    tr = ctx.get("trace")
    if not tr:
        return None
    cats = tr["by_category_ms_per_step"]
    if "elementwise" not in cats and "reduction" not in cats:
        return None
    return cats.get("elementwise", 0.0) + cats.get("reduction", 0.0)
