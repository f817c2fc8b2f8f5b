"""B1's share of its roofline in the traced stretch: its launches times
the frozen least time of one launch at the step's shape (bf16, causal,
``roofline.flash_fwd_bound_s``), over the device time of the kernels
named ``flash_fwd``."""

from benchmark.trace import kernel_time


def read(ctx):
    if ctx.trace is None:
        return None
    t, n = kernel_time(ctx.trace, "flash_fwd")
    if n == 0 or t <= 0:
        return None
    cfg, mix = ctx.cell.cfg, ctx.cell.mix
    h = cfg["num_attention_heads"]
    bound = ctx.roofline.flash_fwd_bound_s(
        mix["batch"], mix["seq_len"], mix["seq_len"], h,
        cfg["hidden_size"] // h, causal=True)
    return 100.0 * n * bound / t
