"""B2 and B3's share of their roofline in the traced stretch: the launches
of each times the frozen least time of one launch at the step's shape
(bf16, causal, ``roofline.flash_bwd_bound_s``'s ``dkdv`` and ``dq``), over
the device time of the kernels named ``flash_bwd_dkdv`` and
``flash_bwd_dq``."""

from benchmark.trace import kernel_time


def read(ctx):
    if ctx.trace is None:
        return None
    t_kv, n_kv = kernel_time(ctx.trace, "flash_bwd_dkdv")
    t_q, n_q = kernel_time(ctx.trace, "flash_bwd_dq")
    if n_kv + n_q == 0 or t_kv + t_q <= 0:
        return None
    cfg, mix = ctx.cell.cfg, ctx.cell.mix
    h = cfg["num_attention_heads"]
    bound = ctx.roofline.flash_bwd_bound_s(
        mix["batch"], mix["seq_len"], mix["seq_len"], h,
        cfg["hidden_size"] // h, causal=True)
    return 100.0 * (n_kv * bound["dkdv"] + n_q * bound["dq"]) / (t_kv + t_q)
