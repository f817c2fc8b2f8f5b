"""Mean self time of the port's ``serve.step`` spans that ran a decode
dispatch: each span's length less the ``serve.prefill`` spans inside it
(the admissions of that step)."""


def read(ctx):
    prefill = {}
    for sp in ctx.spans:
        if sp.name == "serve.prefill" and sp.parent_id is not None:
            prefill[sp.parent_id] = prefill.get(sp.parent_id, 0.0) + sp.duration_s
    own = [sp.duration_s - prefill.get(sp.span_id, 0.0) for sp in ctx.spans
           if sp.name == "serve.step" and "live" in sp.attrs]
    return 1e3 * sum(own) / len(own) if own else None
