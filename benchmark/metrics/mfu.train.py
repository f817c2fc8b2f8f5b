"""The training step's share of the card's bf16 peak: the frozen model
FLOPs of a trained token (``roofline.train_flops_per_token``) times the
tokens a second trained in the traced stretch (its steps, each opened and
closed on a synchronize, over its length; the profiler's start-up is left
outside), over 989 TFLOP/s."""


def read(ctx):
    rate = ctx.window.get("traced_tokens_per_s")
    if not rate:
        return None
    cfg, mix = ctx.cell.cfg, ctx.cell.mix
    flops = ctx.roofline.train_flops_per_token(cfg, mix["seq_len"])
    return 100.0 * flops * rate / ctx.roofline.BF16_FLOPS
