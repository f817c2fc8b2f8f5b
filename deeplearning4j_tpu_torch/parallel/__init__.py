"""Parallel and distributed pieces of the port. Only
:func:`workrouter.update_straggler_flags` is here so far (the serve
fleet's controller shares it); meshes, data/tensor/pipeline parallelism,
the state tracker and the rest of the work router are ROADMAP A14/A15."""
